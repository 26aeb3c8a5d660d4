// Stage stamps: the device side of utils/profiling.phase_scope.
//
// One single-thread kernel per stamp reads the card's %globaltimer (ns) and
// keeps, per slot (stage, pass, mode), the start of the open edge and the
// sum of closed (now - start) spans with their count, in one static int64
// buffer of the program's profiling record:
//   buf[0 .. kSlots)         the open edge's time of each slot;
//   buf[kSlots ..)           the summed ns of each slot's closed spans;
//   buf[2 kSlots ..)         the count of each slot's closed spans.
// The stamps run on the stream in order with the work they bound, so an
// open and its close never race, and the integer sums do not depend on
// timing.  A stamp captured into a CUDA graph hands back its node, and
// cf_stamp_set_new makes two executable graphs of the kept template
// (keep_graph): one with the stamps, launched only while a torch.profiler
// records, and the template itself without them (each node of the work
// that waited for a stamp waits instead for what the stamp waited for),
// which the caller instantiates for the hot path.  A stamp left in the
// graph but disabled would cost the replay 0.5-1 us all the same, 1 % of
// a 1.3 ms step.
//
// Each stage has a kernel of its own name (cf_stamp_<stage>), so a profiler
// trace shows the stage's edges on the device timeline, on the clock of
// every other kernel.  No name contains "spread" or "walk", which name the
// spread and walk kernels in trace readers.
//
// Replaces no TPU kernel: the JAX package's named scopes have no device
// side.  What bounds it: launch latency alone (three words written).

#include <cuda_runtime.h>

#include <algorithm>
#include <utility>
#include <vector>

namespace {

constexpr int kStages = 9;                 // as profiling.TIMED
constexpr int kSlots = kStages * 2 * 2;    // x (forward, backward) x modes

__device__ __forceinline__ void stamp(unsigned long long* buf, int slot,
                                      int open) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  if (open) {
    buf[slot] = now;
  } else {
    buf[kSlots + slot] += now - buf[slot];
    buf[2 * kSlots + slot] += 1;
  }
}

#define CF_STAMP_KERNEL(stage)                                             \
  __global__ void cf_stamp_##stage(unsigned long long* buf, int slot,      \
                                   int open) {                             \
    stamp(buf, slot, open);                                                \
  }

CF_STAMP_KERNEL(charges)
CF_STAMP_KERNEL(binning)
CF_STAMP_KERNEL(direct)
CF_STAMP_KERNEL(exclusion)
CF_STAMP_KERNEL(reciprocal)
CF_STAMP_KERNEL(bonded)
CF_STAMP_KERNEL(rebuild)
CF_STAMP_KERNEL(replay)
CF_STAMP_KERNEL(respa_fast)

#undef CF_STAMP_KERNEL

typedef void (*StampKernel)(unsigned long long*, int, int);
// the stages in the order of profiling.TIMED
const StampKernel kKernels[kStages] = {
    cf_stamp_charges,   cf_stamp_binning,    cf_stamp_direct,
    cf_stamp_exclusion, cf_stamp_reciprocal, cf_stamp_bonded,
    cf_stamp_rebuild,   cf_stamp_replay,     cf_stamp_respa_fast};

// The stamped executable graph of one template, whose stamps were taken
// out of the template.
struct StampSet {
  cudaGraph_t stamped = nullptr;
  cudaGraphExec_t exec = nullptr;
  ~StampSet() {
    if (exec != nullptr) cudaGraphExecDestroy(exec);
    if (stamped != nullptr) cudaGraphDestroy(stamped);
  }
};

cudaError_t edges(cudaGraphNode_t node, bool incoming,
                  std::vector<cudaGraphNode_t>* out) {
  size_t count = 0;
  for (int pass = 0; pass < 2; ++pass) {
    cudaGraphNode_t* dst = pass ? out->data() : nullptr;
#if CUDART_VERSION >= 13000
    cudaError_t err =
        incoming ? cudaGraphNodeGetDependencies(node, dst, nullptr, &count)
                 : cudaGraphNodeGetDependentNodes(node, dst, nullptr, &count);
#else
    cudaError_t err = incoming
                          ? cudaGraphNodeGetDependencies(node, dst, &count)
                          : cudaGraphNodeGetDependentNodes(node, dst, &count);
#endif
    if (err != cudaSuccess) return err;
    if (pass == 0) out->resize(count);
    if (count == 0) break;
  }
  return cudaSuccess;
}

// The nodes of the work that stamp `node` waits for, through the stamps
// before it.
cudaError_t work_before(const std::vector<cudaGraphNode_t>& stamps,
                        cudaGraphNode_t node,
                        std::vector<cudaGraphNode_t>* out) {
  std::vector<cudaGraphNode_t> deps;
  cudaError_t err = edges(node, true, &deps);
  for (size_t k = 0; k < deps.size() && err == cudaSuccess; ++k) {
    if (std::find(stamps.begin(), stamps.end(), deps[k]) != stamps.end()) {
      err = work_before(stamps, deps[k], out);
    } else if (std::find(out->begin(), out->end(), deps[k]) == out->end()) {
      out->push_back(deps[k]);
    }
  }
  return err;
}

}  // namespace

extern "C" {

// The slots the buffer holds (its length is 3 * slots).
int cf_stamp_limits(int* slots, int* stages) {
  *slots = kSlots;
  *stages = kStages;
  return 0;
}

// One stamp of `slot` (open or close) on `stream`.  Where `node` is given,
// it receives the stamp's node in the graph `stream` is capturing, or NULL
// where the stream does not capture.
int cf_stage_stamp(unsigned long long* buf, int slot, int open, void* stream,
                   void** node) {
  if (slot < 0 || slot >= kSlots) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  kKernels[slot / 4]<<<1, 1, 0, s>>>(buf, slot, open);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || node == nullptr) return (int)err;
  *node = nullptr;
  // the node just captured is the one the stream's next node would follow
  cudaStreamCaptureStatus status;
  const cudaGraphNode_t* deps = nullptr;
  size_t n = 0;
#if CUDART_VERSION >= 13000
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, nullptr, &deps,
                                 nullptr, &n);
#else
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, nullptr, &deps, &n);
#endif
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive) return 0;
  if (n != 1) return (int)cudaErrorInvalidValue;
  *node = deps[0];
  return 0;
}

// Instantiate the graph template `graph` as it is, with its `n` stamp
// nodes `nodes`, then take those out of the template: a node of the work
// that waited for a stamp waits instead for the work the stamp waited for
// (*bridged such edges made).  *out is the StampSet, whose graph
// cf_stamp_set_launch launches, to be released by cf_stamp_set_free.
int cf_stamp_set_new(void* graph, void** nodes, int n, void** out,
                     int* bridged) {
  *out = nullptr;
  *bridged = 0;
  const cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  const std::vector<cudaGraphNode_t> stamps(
      reinterpret_cast<cudaGraphNode_t*>(nodes),
      reinterpret_cast<cudaGraphNode_t*>(nodes) + n);
  StampSet* set = new StampSet();
  cudaError_t err = cudaGraphClone(&set->stamped, g);
  if (err == cudaSuccess) err = cudaGraphInstantiate(&set->exec,
                                                     set->stamped, 0);
  // the edges that keep the work's order without the stamps
  std::vector<std::pair<cudaGraphNode_t, cudaGraphNode_t>> bridges;
  std::vector<cudaGraphNode_t> after, before, held;
  for (int i = 0; i < n && err == cudaSuccess; ++i) {
    err = edges(stamps[i], false, &after);
    before.clear();
    for (size_t k = 0; k < after.size() && err == cudaSuccess; ++k) {
      if (std::find(stamps.begin(), stamps.end(), after[k]) != stamps.end())
        continue;
      if (before.empty()) err = work_before(stamps, stamps[i], &before);
      if (err == cudaSuccess) err = edges(after[k], true, &held);
      for (cudaGraphNode_t m : before) {
        bool known = std::find(held.begin(), held.end(), m) != held.end();
        for (const auto& e : bridges)
          known = known || (e.first == m && e.second == after[k]);
        if (!known) bridges.emplace_back(m, after[k]);
      }
    }
  }
  for (int i = 0; i < n && err == cudaSuccess; ++i)
    err = cudaGraphDestroyNode(stamps[i]);
  for (size_t k = 0; k < bridges.size() && err == cudaSuccess; ++k) {
#if CUDART_VERSION >= 13000
    err = cudaGraphAddDependencies(g, &bridges[k].first, &bridges[k].second,
                                   nullptr, 1);
#else
    err = cudaGraphAddDependencies(g, &bridges[k].first, &bridges[k].second,
                                   1);
#endif
  }
  if (err != cudaSuccess) {
    delete set;
    return (int)err;
  }
  *bridged = (int)bridges.size();
  *out = set;
  return 0;
}

// Launch the stamped graph of `handle` on `stream`.
int cf_stamp_set_launch(void* handle, void* stream) {
  return (int)cudaGraphLaunch(static_cast<StampSet*>(handle)->exec,
                              static_cast<cudaStream_t>(stream));
}

void cf_stamp_set_free(void* handle) { delete static_cast<StampSet*>(handle); }

}  // extern "C"
