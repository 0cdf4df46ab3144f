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
// The reduction is block_hist.cuh's cluster histogram: every dense plan up
// to 65,536 slots keeps its [n_slots, 3] table on chip (a private table per
// block up to about 19k slots, split over a cluster beyond, each row added
// into the owning rank's shared memory through distributed shared memory),
// flushed with coalesced global atomics. The measure channel adds as a
// float; the valid-measure and row counts, integers by construction, add
// with native integer shared-memory atomics, local or remote. Each
// 1,024-thread block evaluates K1_UNROLL rows a thread and pass, one block
// width apart (rows i, i + blockDim.x, ...): every load instruction stays
// coalesced across the warp, and the unrolled rows' column loads are all
// issued before their updates, so they overlap.
//
// Build and launch: a plan's source is device code only. NVRTC compiles it
// to a cubin inside the process (cuda_build's "nvrtc" kind): no compiler
// process, no host code, no link; under __CUDACC_RTC__ it reaches no
// system header (ares_common.cuh names the few C library types it takes,
// ares_cluster.cuh calls the cluster built-ins directly), so the compile
// parses this file, the row function and the csrc headers alone. The
// fixed launcher library (fused_dense_launch.cu, built once)
// loads that image, finds `fused_dense_kernel` by name, sizes the launch
// with block_hist.cuh's hist_plan and launches it. The two agree on the
// kernel's parameters through the ABI block below, which the launcher
// includes alone (ARES_K1_ABI_ONLY), and check them against the image's
// own parameter sizes at load.
//
// A plan's source holds its structure only. The values that move with the
// query's `now` or with the data (number literals, the time-filter bounds
// among them, each dense domain's base, size and stride) are the plan's
// literal block, AresLits, which the kernel takes by value, so its reads
// come from the constant bank with no local copy (0-byte stack frame).
// (__constant__ memory would race between launches on two streams.) So a
// moved window or a moved column range launches the cubin already built.
// The cost: those values no longer fold into the arithmetic, which
// on the smoke's plans takes up to 14 more registers and up to 8.5% more
// kernel time (PERF.md). A plan whose literals overflow the block
// (fused_dense.MAX_LITS) bakes them into its source, with ARES_NI and
// ARES_NF 0.
//
// Under a host C++ compiler only the row-function harness below is built:
// the CPU tests compare its per-row lanes with the plain PyTorch emitter.
#pragma once

#include "ares_common.cuh"

// The kernel's ABI, shared with its launcher: fused_dense_kernel's
// parameters are (AresCols, AresLits, n, n_valid, tcol, cutoff,
// HistLayout, out, ovf); AresLits holds 4 * (max(ARES_NI, 1) +
// max(ARES_NF, 1)) bytes, its ints then its floats.
#define ARES_MAX_COLS 24
// rows a thread evaluates before it adds any of them
#define K1_UNROLL 2
// block_sum_int keeps 32 ints of static shared memory
#define K1_STATIC_BYTES (32 * sizeof(int))

struct AresCols {
  const void* v[ARES_MAX_COLS];
  const bool* b[ARES_MAX_COLS];
};

#ifndef ARES_K1_ABI_ONLY

struct AresRow {
  bool keep;    // the plan's filters pass (before the n_valid/cutoff mask)
  bool bad;     // a valid dimension value lies outside the planned domain
  int slot;     // dense slot; meaningful when keep && !bad
  float mval;   // measure value
  bool mvalid;  // measure validity
};

// The generated source defines the block's counts before it includes
// this header; they depend on the plan's structure only.
#if !defined(ARES_NI) || !defined(ARES_NF)
#error "define ARES_NI and ARES_NF before including fused_dense_template.cuh"
#endif

// The plan's literal block (FusedSpec.lits_i, lits_f), at least one slot
// each.
struct AresLits {
  int i[ARES_NI > 0 ? ARES_NI : 1];
  float f[ARES_NF > 0 ? ARES_NF : 1];
};

// Generated per plan by fused_dense.emit_cuda. V[j], B[j]: values and
// validity of the plan's j-th input (FusedSpec.input_keys order: the
// main-table columns, then the joined columns gathered into [n] lanes);
// P: the plan's literal block.
ARES_DEV void ares_row(const void* const* V, const bool* const* B,
                       long long i, const AresLits& P, AresRow& r);

// Copies the host arrays of the block into it.
ARES_HD AresLits ares_lits(const int* lits_i, const float* lits_f) {
  AresLits lits = {};
  for (int k = 0; k < ARES_NI; ++k) lits.i[k] = lits_i[k];
  for (int k = 0; k < ARES_NF; ++k) lits.f[k] = lits_f[k];
  return lits;
}

#ifdef __CUDACC__
// the cubin holds device code only: none of block_hist.cuh's host helpers
// (NVRTC's options define it too)
#ifndef ARES_DEVICE_ONLY
#define ARES_DEVICE_ONLY
#endif
#include "block_hist.cuh"

// fused_dense_kernel's parameters: AresCols (384 bytes), AresLits (at
// most 4 * (MAX_LITS + 1) = 2,052 bytes), six 8-byte scalars and pointers
// and HistLayout (24), with padding, within the classic 4,096-byte limit
static_assert(sizeof(AresCols) + sizeof(AresLits) + 6 * 8 +
                      sizeof(HistLayout) + 8 <= 4096,
              "fused_dense_kernel's parameters exceed 4 KB");

// Whether row i is live: below n_valid and, with a time column, at or
// after the archiving cutoff.
__device__ __forceinline__ bool row_live(long long i, long long n_valid,
                                         const int* tcol, long long cutoff) {
  bool pre = i < n_valid;
  if (tcol != nullptr) pre = pre && (long long)(uint32_t)tcol[i] >= cutoff;
  return pre;
}

// Fold one evaluated row into the cluster table; 1 where it is out of its
// planned domain (the overflow count), else 0.
__device__ __forceinline__ int fold_row(float* hist, const HistLayout& L,
                                        bool pre, const AresRow& r) {
  const bool mask = pre && r.keep;
  if (!mask) return 0;
  if (r.bad) return 1;
  if (!hist_takes<HIST_SPLIT_DSMEM>(L, r.slot)) return 0;
  // an invalid measure adds +0 whatever its bits (NaN included)
  const float v[3] = {r.mvalid ? r.mval : 0.f, r.mvalid ? 1.f : 0.f, 1.f};
  cluster_hist_add<HIST_SPLIT_DSMEM, 3, 1>(hist, L, r.slot, v);
  return 0;
}

// __launch_bounds__: ptxas keeps every plan's row function within the 64
// registers a thread of a 1,024-thread block may use. __grid_constant__:
// the row function reads cols and lits through references to the
// parameters themselves, which this qualifier allows without a copy.
// extern "C": the launcher finds the kernel in the image by this name.
extern "C" __global__ void __launch_bounds__(1024)
    fused_dense_kernel(const __grid_constant__ AresCols cols,
                       const __grid_constant__ AresLits lits, long long n,
                       long long n_valid, const int* tcol, long long cutoff,
                       HistLayout L, float* __restrict__ out,
                       int* __restrict__ ovf) {
  extern __shared__ float hist[];
  cluster_hist_zero(hist, L);
  int my_ovf = 0;
  const HistPart pt = hist_part<HIST_SPLIT_DSMEM>(L);
  const long long tile = (long long)blockDim.x * K1_UNROLL;
  for (long long t0 = pt.part * tile; t0 < n; t0 += pt.n_parts * tile) {
    const long long i0 = t0 + threadIdx.x;
    if (t0 + tile <= n) {
      AresRow r[K1_UNROLL];
      bool pre[K1_UNROLL];
#pragma unroll
      for (int k = 0; k < K1_UNROLL; ++k) {
        const long long i = i0 + (long long)k * blockDim.x;
        pre[k] = row_live(i, n_valid, tcol, cutoff);
        ares_row(cols.v, cols.b, i, lits, r[k]);
      }
#pragma unroll
      for (int k = 0; k < K1_UNROLL; ++k)
        my_ovf += fold_row(hist, L, pre[k], r[k]);
    } else {
      for (int k = 0; k < K1_UNROLL; ++k) {
        const long long i = i0 + (long long)k * blockDim.x;
        if (i >= n) break;
        AresRow r;
        ares_row(cols.v, cols.b, i, lits, r);
        my_ovf += fold_row(hist, L, row_live(i, n_valid, tcol, cutoff), r);
      }
    }
  }
  const int total = block_sum_int(my_ovf);
  if (threadIdx.x == 0 && total != 0) atomicAdd(ovf, total);
  cluster_hist_flush<3, 1>(hist, L, out, 1, L.n_slots);
}

#else

// Host harness: the per-row lanes of ares_row for rows [0, n), with the
// literal block from lits_i and lits_f.
extern "C" void ares_rows_host(const void* const* V, const bool* const* B,
                               const int* lits_i, const float* lits_f,
                               long long n, unsigned char* keep,
                               unsigned char* bad, int* slot, float* mval,
                               unsigned char* mvalid) {
  const AresLits lits = ares_lits(lits_i, lits_f);
  for (long long i = 0; i < n; ++i) {
    AresRow r;
    ares_row(V, B, i, lits, r);
    keep[i] = r.keep;
    bad[i] = r.bad;
    slot[i] = r.slot;
    mval[i] = r.mval;
    mvalid[i] = r.mvalid;
  }
}

#endif

#endif  // ARES_K1_ABI_ONLY
