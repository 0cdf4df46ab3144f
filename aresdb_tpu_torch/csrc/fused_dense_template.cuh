// K1: fused dense group-by. One pass over a batch's staged columns: the
// plan's filters, dimensions and measure for each row, its dense slot, the
// count of out-of-domain rows, and the per-slot reduction of (measure sum,
// valid-measure count, row count) into out[3, n_slots].
//
// Replaces aresdb_tpu/query/fused_dense.py _make_kernel
// (make_fused_dense_kernel). The Pallas body is traced per plan; here the
// per-row work is emitted per plan as C (fused_dense.emit_cuda) and this
// fixed template wraps it: the generated source includes this header and
// then defines ares_row. The TPU kernel's sub-word packing, bf16 hi/lo
// split and one-step-late dot buffer exist only for Mosaic and the MXU and
// are not ported: columns are read as staged (u8/u16/u32/i32/f32 values,
// bool validity) and reduced with block_hist.cuh.
//
// Bound on this card: the bytes read, each staged column's values and
// validity once (about 15 B/row for the headline query), at 3.35 TB/s.
// One thread per row keeps the loads coalesced; the shared-memory
// histogram keeps the scatter out of device memory up to ~19k slots;
// wider slot spaces (up to 65,536) add into device memory directly.
//
// Under a host C++ compiler only the row-function harness below is built:
// the CPU tests compare its per-row lanes with the plain PyTorch emitter.
#pragma once

#include "ares_common.cuh"

#define ARES_MAX_COLS 24

struct AresRow {
  bool keep;    // the plan's filters pass (before the n_valid/cutoff mask)
  bool bad;     // a valid dimension value lies outside the planned domain
  int slot;     // dense slot; meaningful when keep && !bad
  float mval;   // measure value
  bool mvalid;  // measure validity
};

// Generated per plan by fused_dense.emit_cuda. V[j], B[j]: values and
// validity of the plan's j-th column (FusedSpec.col_ids order).
ARES_DEV void ares_row(const void* const* V, const bool* const* B,
                       long long i, AresRow& r);

#ifdef __CUDACC__
#include "block_hist.cuh"

struct AresCols {
  const void* v[ARES_MAX_COLS];
  const bool* b[ARES_MAX_COLS];
};

__global__ void fused_dense_kernel(AresCols cols, long long n,
                                   long long n_valid, const int* tcol,
                                   long long cutoff, int n_slots,
                                   int shared, float* __restrict__ out,
                                   int* __restrict__ ovf) {
  extern __shared__ float hist[];
  if (shared) hist_zero(hist, n_slots * 3);
  int my_ovf = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    // pre-mask: padded rows, and live rows below the archiving cutoff
    bool pre = i < n_valid;
    if (tcol != nullptr) pre = pre && (long long)(uint32_t)tcol[i] >= cutoff;
    AresRow r;
    ares_row(cols.v, cols.b, i, r);
    const bool mask = pre && r.keep;
    my_ovf += (mask && r.bad) ? 1 : 0;
    if (!mask || r.bad) continue;
    // an invalid measure adds +0 whatever its bits (NaN included)
    const float mv = r.mvalid ? r.mval : 0.f;
    const float mc = r.mvalid ? 1.f : 0.f;
    if (shared) {
      atomicAdd(&hist[r.slot * 3 + 0], mv);
      atomicAdd(&hist[r.slot * 3 + 1], mc);
      atomicAdd(&hist[r.slot * 3 + 2], 1.f);
    } else {
      atomicAdd(&out[r.slot], mv);
      atomicAdd(&out[(long long)n_slots + r.slot], mc);
      atomicAdd(&out[2LL * n_slots + r.slot], 1.f);
    }
  }
  const int total = block_sum_int(my_ovf);
  if (threadIdx.x == 0 && total != 0) atomicAdd(ovf, total);
  if (shared) hist_flush(hist, n_slots, 3, out, 1, n_slots);
}

// Bytes of dynamic shared memory a launch over n_slots gives its block
// histogram; 0 where the histogram does not fit and the kernel adds into
// global memory directly.
extern "C" long long ares_fused_dense_smem(int n_slots, int device) {
  const size_t hist_bytes = (size_t)n_slots * 3 * sizeof(float);
  // block_sum_int keeps 32 ints of static shared memory
  return shared_hist_fits(device, hist_bytes, 32 * sizeof(int))
             ? (long long)hist_bytes : 0;
}

// vals/valids: n_cols device pointers each; tcol: the uint32 time column
// for the cutoff mask, or null; out: float32 [3, n_slots] and ovf: int32
// [1], both zeroed by the caller. Launches on `stream`, allocates nothing,
// returns the launch's cudaError_t.
extern "C" int ares_fused_dense(const void* const* vals,
                                const void* const* valids, int n_cols,
                                long long n, long long n_valid,
                                const void* tcol, long long cutoff,
                                int n_slots, void* out, void* ovf, int device,
                                void* stream) {
  if (n_cols > ARES_MAX_COLS) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  AresCols cols = {};
  for (int j = 0; j < n_cols; ++j) {
    cols.v[j] = vals[j];
    cols.b[j] = (const bool*)valids[j];
  }
  const int threads = 512;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)ares_fused_dense_smem(n_slots, device);
  const int shared = smem > 0;
  if (shared) {
    err = cudaFuncSetAttribute(
        fused_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = rows_grid(fused_dense_kernel, device, threads, smem, n);
  fused_dense_kernel<<<grid, threads, smem, st>>>(
      cols, n, n_valid, (const int*)tcol, cutoff, n_slots, shared,
      (float*)out, (int*)ovf);
  return (int)cudaGetLastError();
}

#else

// Host harness: the per-row lanes of ares_row for rows [0, n).
extern "C" void ares_rows_host(const void* const* V, const bool* const* B,
                               long long n, unsigned char* keep,
                               unsigned char* bad, int* slot, float* mval,
                               unsigned char* mvalid) {
  for (long long i = 0; i < n; ++i) {
    AresRow r;
    ares_row(V, B, i, r);
    keep[i] = r.keep;
    bad[i] = r.bad;
    slot[i] = r.slot;
    mval[i] = r.mval;
    mvalid[i] = r.mvalid;
  }
}

#endif
