// mips_topk — per-row top-k of q @ yᵀ, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_mips_kernel` of
// src/repro/kernels/mips_topk.py (public `mips_topk`, merge
// `merge_topk_tile` of src/repro/kernels/topk_merge.py). It computes what
// that kernel computes, not its block structure:
//
//   vals, ids = top-k over columns c of (q @ yᵀ)[:, c], for c < C with
//   valid[c] != 0, keyed by (value descending, id ascending), with
//   ids = id_offset + c (int32). Slots left without a real score hold
//   (NEG_INF, ID_PAD). No backward: selection is non-differentiable.
//
// What bounds it on an H100. At the serve shapes (C = 173,520 catalog
// rows, d = 64, k = 10):
//   * bucket 512: 2·512·173,520·64 ≈ 11.4 GFLOP of f32 FMAs — above the
//     card's balance point, so the f32 (non-tensor-core) FMA rate bounds it;
//   * bucket 8: the catalog read, 173,520·64·4 B ≈ 44.4 MB, bounds it —
//     ≈ 178 MFLOP is nothing next to it.
// The scores stay f32 FMAs in a fixed order over d (no TF32, no tensor
// cores): the ids must equal the plain version's, and on integer-valued
// inputs every fold order is exact, so ties resolve bit for bit.
//
// Design. The TPU grid walks the catalog axis sequentially with the merge
// buffer in VMEM; ported as is, bucket 8 would run one block on one of
// 132 SMs. Here the catalog is split instead:
//   1. mips_topk_partial_kernel, grid (ceil(n_q / QB), S): S splits the
//      catalog (the wrapper's plan, measured on the card). Each block
//      stages its QB query rows in shared memory once and streams its
//      split in (64, d) catalog tiles with cp.async into a double buffer,
//      so the next tile's read overlaps this tile's arithmetic (the bytes
//      side: bucket 8). Every thread computes an RM×4 register tile of scores
//      from float4 shared-memory reads — 16·RM FMAs per 4+RM loads (the
//      FLOP side: bucket 512). It then compares its own scores with its
//      rows' current k-th entries; only the few that beat them go to a
//      per-row candidate buffer, and a warp merges those into the row's
//      sorted top-k list by rank (each element's new position is the
//      number of elements that precede it). The block writes its lists
//      as (n_q, S, k) candidates.
//   2. mips_topk_merge_kernel, one block per row: each of 8 warps merges a
//      share of the row's S sorted lists the same way, then warp 0 merges
//      the 8 warp lists and writes ID_PAD wherever the value is NEG_INF
//      (the exhausted-row rule of topk_merge.py).
// Candidate buffers fill in any order, but a rank under a strict total
// order does not depend on it, and there are no global atomics: the result
// is deterministic. k ≤ 512, d ≤ 256.
//
// The per-row lists live in shared memory; each lane of a merging warp
// holds SLOTS of a list's entries in registers while it ranks them: 8 for
// k ≤ 256 (serving's k = 10, SCE training's catalog selection b_y = 256),
// 16 for k ≤ 512 (the position selection, b_x = 320 at the paper's
// shape). The merge is by merge path: it first puts the ≤ 64 candidates
// in key order, then places each element by a binary search of the other
// side, O(log k + log n) per element, where ranking it by a scan of the
// other side costs O(k + n): a 320-entry list once per candidate.
//
// The loader, the score loop, the filter, both merges and the split
// sweep are the tile code of topk_tile.cuh, which eval_fused.cu shares.
//
// Built by src/repro_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes in src/repro_torch/kernels/mips_topk.py.

#include "topk_tile.cuh"

namespace {

using namespace topk_tile;

template <int RM, int SLOTS>
__global__ void __launch_bounds__(kThreads)
mips_topk_partial_kernel(Sweep a) {
  extern __shared__ float4 smem4[];
  sweep_split<RM, SLOTS>(a, smem4, [](const float (&)[RM][kColsPerThread],
                                      const int*, long) {});
}

template <int SLOTS>
__global__ void __launch_bounds__(kThreads)
mips_topk_merge_kernel(const float* __restrict__ part_vals,
                       const int* __restrict__ part_ids,
                       float* __restrict__ vals, int* __restrict__ ids,
                       int n_split, int k) {
  extern __shared__ float4 smem4[];
  merge_split_lists<SLOTS>(part_vals, part_ids, vals, ids, n_split, k,
                           smem4);
}

// The partial pass at block height RM, then the merge, both at list
// width SLOTS.
template <int RM, int SLOTS>
cudaError_t launch_pair(const Sweep& a, float* vals, int* ids, int n_split,
                        cudaStream_t s) {
  static bool done[kMaxDevices] = {};
  const size_t smem = partial_smem_bytes<RM>(a.d, a.k);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = allow_max_smem(mips_topk_partial_kernel<RM, SLOTS>, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n_q + 16 * RM - 1) / (16 * RM), n_split);
  mips_topk_partial_kernel<RM, SLOTS><<<grid, kThreads, smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mips_topk_merge_kernel<SLOTS><<<a.n_q, kThreads, merge_smem_bytes(a.k), s>>>(
      a.part_vals, a.part_ids, vals, ids, n_split, a.k);
  return cudaGetLastError();
}

}  // namespace

// Launches the partial pass then the merge on `stream`. part_vals /
// part_ids are (n_q, n_split, k) scratch, vals / ids the (n_q, k)
// outputs; valid is a (C,) bool mask (one byte per row) or null.
// Returns the cudaError_t of the launches (0 on success), and
// cudaErrorInvalidValue when a partial block would need more than
// kMaxSmem (the wrapper's plan keeps it under). Nothing is synchronised
// and nothing is allocated.
extern "C" int mips_topk_launch(const float* q, const float* y,
                                const unsigned char* valid, float* part_vals,
                                int* part_ids, float* vals, int* ids, int n_q,
                                int c, int d, int k, int rows_per_thread,
                                int n_split, int split_cols, int id_offset,
                                void* stream) {
  if (n_q <= 0 || c <= 0 || d <= 0 || d > kMaxD || k <= 0 || k > kMaxK ||
      k > c || n_split <= 0 || split_cols <= 0 || split_cols % kTileC != 0 ||
      (long)n_split * split_cols < (long)c)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // No window: [id_offset, id_offset + c) holds every row.
  const Sweep a{q, y, valid, part_vals, part_ids, n_q, c, d, k, split_cols,
                id_offset, id_offset, id_offset + c,
                d % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0};
  return (int)dispatch(rows_per_thread, k, [&](auto rm, auto slots) {
    return launch_pair<decltype(rm)::value, decltype(slots)::value>(
        a, vals, ids, n_split, s);
  });
}
