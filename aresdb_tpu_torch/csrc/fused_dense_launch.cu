// K1's launcher: the fixed host half of the fused dense group-by (K1,
// fused_dense_template.cuh), built once into a library and shared by every
// plan structure.
//
// Replaces the host launcher each per-plan library used to carry. A plan
// structure is now device code only, a cubin NVRTC compiles in process;
// this library loads its image through the CUDA runtime's library API
// (cudaLibraryLoadData, cudaLibraryGetKernel: a handle tied to no context,
// so a launch on another device loads it there), checks the kernel's
// parameters against the ABI that fused_dense_template.cuh states, sizes
// the launch with block_hist.cuh's hist_plan on the handle and launches it
// with the cluster attribute (hist_launch_args). The launch itself is the
// one the per-plan libraries made: the same policy, grid, cluster and
// parameters. ares_fused_dense_batches makes a query's launches of one
// structure and literal block in one call: one launch a batch, each into
// its own slice of one output table.
//
// It holds no device code, so it is compiled as C++ by the host compiler
// (cuda_build's "host" kind: nvcc -x c++), with the CUDA runtime linked in.
#define ARES_K1_ABI_ONLY
#include "fused_dense_template.cuh"

#define ARES_HIST_HOST
#include "block_hist.cuh"

#include <string.h>

// the literal block's words (ints then floats) a launch may pass: a
// parameter space of 4 KB holds fewer
#define K1_MAX_LIT_WORDS 1024

// The bytes of fused_dense_kernel's parameter k for a literal block of
// (ni, nf) values; 0 past the last parameter.
static size_t k1_param_bytes(int k, int ni, int nf) {
  const size_t lits = 4 * (size_t)((ni > 0 ? ni : 1) + (nf > 0 ? nf : 1));
  const size_t bytes[] = {sizeof(AresCols), lits, 8, 8, 8, 8,
                          sizeof(HistLayout), 8, 8};
  return k < (int)(sizeof(bytes) / sizeof(bytes[0])) ? bytes[k] : 0;
}

typedef int (*KernelParamInfo)(void* kernel, size_t index, size_t* offset,
                               size_t* size);

// cuKernelGetParamInfo (CUDA 12.4 on), looked up through the runtime
// (cudaGetDriverEntryPointByVersion), so that the library links no
// libcuda; null where the installed CUDA lacks it.
static KernelParamInfo param_info() {
  void* fn = nullptr;
#if CUDART_VERSION >= 12050
  cudaDriverEntryPointQueryResult found;
  if (cudaGetDriverEntryPointByVersion("cuKernelGetParamInfo", &fn, 12040,
                                       cudaEnableDefault,
                                       &found) != cudaSuccess ||
      found != cudaDriverEntryPointSuccess)
    fn = nullptr;
  cudaGetLastError();
#endif
  return (KernelParamInfo)fn;
}

// Loads one plan structure's cubin image (`image`, kept alive by the
// caller for the life of the process) on `device` and returns its kernel
// in *kernel. 0 on success; a cudaError_t; or -(k + 1) where the image's
// parameter k does not have the size the ABI gives it for (ni, nf)
// literals, and -100 where the image has more parameters than the ABI.
extern "C" int ares_fused_dense_load(const void* image, int ni, int nf,
                                     int device, void** kernel) {
  *kernel = nullptr;
  if (ni < 0 || nf < 0 ||
      (ni > 0 ? ni : 1) + (nf > 0 ? nf : 1) > K1_MAX_LIT_WORDS)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaLibrary_t lib;
  err = cudaLibraryLoadData(&lib, image, nullptr, nullptr, 0, nullptr,
                            nullptr, 0);
  if (err != cudaSuccess) return (int)err;
  cudaKernel_t k;
  err = cudaLibraryGetKernel(&k, lib, "fused_dense_kernel");
  if (err != cudaSuccess) return (int)err;
  const KernelParamInfo info = param_info();
  if (info != nullptr) {
    for (int p = 0;; ++p) {
      size_t offset = 0, size = 0;
      const bool has = info((void*)k, (size_t)p, &offset, &size) == 0;
      const size_t want = k1_param_bytes(p, ni, nf);
      if (!has && want == 0) break;
      if (!has || size != want) return want == 0 ? -100 : -(p + 1);
    }
  }
  *kernel = (void*)k;
  return 0;
}

// The cluster size a launch over n_slots takes (0: no cluster holds the
// table, and the launch fails).
extern "C" int ares_fused_dense_cluster(int n_slots, int device) {
  long long optin = 0;
  int max_cluster = 0;
  hist_device_limits(device, &optin, &max_cluster);
  return hist_policy(n_slots, 3, K1_STATIC_BYTES, optin, max_cluster);
}

// The registers a thread of `kernel` (a handle from ares_fused_dense_load)
// takes and its local memory bytes (its stack frame, spills included), as
// the loaded image states them. 0 on success, else a cudaError_t.
extern "C" int ares_fused_dense_usage(const void* kernel, int device,
                                      int* regs, int* local_bytes) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

// Sizes a launch of `kernel` over n rows into n_slots as ares_fused_dense
// does (hist_plan: the card's limits and, once a kernel and shape, the
// occupancy query), without launching it: the clusters of its persistent
// grid, 0 where no cluster holds the table, or minus a cudaError_t.
extern "C" int ares_fused_dense_plan(const void* kernel, int n_slots,
                                     long long n, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  HistLaunch h;
  if (!hist_plan<HIST_SPLIT_DSMEM>(kernel, device, n_slots, 3,
                                   K1_STATIC_BYTES, n, K1_UNROLL, &h))
    return 0;
  return h.clusters;
}

// kernel: a handle from ares_fused_dense_load, whose plan has (ni, nf)
// literals; vals/valids: n_cols device pointers each; lits_i/lits_f: the
// host arrays of the plan's literal block, copied into the launch's
// parameters; tcol: the uint32 time column for the cutoff mask, or null;
// out: float32 [3, n_slots] and ovf: int32 [1], both zeroed by the
// caller. Launches on `stream`, allocates nothing, returns the launch's
// cudaError_t (cudaErrorInvalidValue where no cluster holds the table).
extern "C" int ares_fused_dense(const void* kernel, int ni, int nf,
                                const void* const* vals,
                                const void* const* valids, int n_cols,
                                const int* lits_i, const float* lits_f,
                                long long n, long long n_valid,
                                const void* tcol, long long cutoff,
                                int n_slots, void* out, void* ovf, int device,
                                void* stream) {
  const int wi = ni > 0 ? ni : 1, wf = nf > 0 ? nf : 1;
  if (kernel == nullptr || n_cols > ARES_MAX_COLS || ni < 0 || nf < 0 ||
      wi + wf > K1_MAX_LIT_WORDS)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  AresCols cols = {};
  for (int j = 0; j < n_cols; ++j) {
    cols.v[j] = vals[j];
    cols.b[j] = (const bool*)valids[j];
  }
  // AresLits: ARES_NI ints, then ARES_NF floats, each at least one word
  unsigned lits[K1_MAX_LIT_WORDS] = {};
  memcpy(lits, lits_i, 4 * (size_t)ni);
  memcpy(lits + wi, lits_f, 4 * (size_t)nf);
  HistLaunch h;
  if (!hist_plan<HIST_SPLIT_DSMEM>(kernel, device, n_slots, 3,
                                   K1_STATIC_BYTES, n, K1_UNROLL, &h))
    return (int)cudaErrorInvalidValue;
  const int* t = (const int*)tcol;
  float* o = (float*)out;
  int* v = (int*)ovf;
  void* args[] = {&cols, lits, &n, &n_valid, &t, &cutoff, &h.L, &o, &v};
  err = hist_launch_args(kernel, h, (cudaStream_t)stream, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// A query's K1 batches of one plan structure and literal block, in one
// call: batch b is launched as ares_fused_dense launches it, with
// vals/valids[b * n_cols, (b + 1) * n_cols), ns[b] rows, n_valids[b],
// tcols[b] and cutoffs[b], into slice b of out (float32 [n_batches, 3,
// n_slots]) and entry b of ovf (int32 [n_batches]), both zeroed by the
// caller. The launches go on `stream` in batch order. Returns 0, or the
// first failing launch's cudaError_t; the batches after it are not
// launched.
extern "C" int ares_fused_dense_batches(
    const void* kernel, int ni, int nf, int n_batches,
    const void* const* vals, const void* const* valids, int n_cols,
    const int* lits_i, const float* lits_f, const long long* ns,
    const long long* n_valids, const void* const* tcols,
    const long long* cutoffs, int n_slots, void* out, void* ovf, int device,
    void* stream) {
  if (n_batches < 0 || n_cols < 0 || n_slots <= 0)
    return (int)cudaErrorInvalidValue;
  for (int b = 0; b < n_batches; ++b) {
    const size_t at = (size_t)b * (size_t)n_cols;
    const int rc = ares_fused_dense(
        kernel, ni, nf, vals + at, valids + at, n_cols, lits_i, lits_f,
        ns[b], n_valids[b], tcols[b], cutoffs[b], n_slots,
        (float*)out + (size_t)b * 3 * (size_t)n_slots, (int*)ovf + b, device,
        stream);
    if (rc != 0) return rc;
  }
  return 0;
}
