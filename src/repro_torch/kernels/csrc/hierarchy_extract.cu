// The offline pass's extract stage (kernels/hierarchy.py::extract) as one
// launch of one thread block: stabilities, the EOM sweep (or the leaf rule),
// selection blocking, allow_single_cluster, the ranks, each label's nearest
// selected ancestor, the leaves' flat labels and the cluster count.
//
// It stands for the JAX package's extract_fixed (core/hierarchy_jax.py:288,
// the lax.scan EOM sweep at :336 and the jnp scatters and doubling loops
// around it), which has no Pallas kernel.  Its bits are those of the port's
// plain extract_fixed (core/hierarchy.py) in every field, the stabilities
// included: both add each label's terms one f32 add at a time from +0.0, its
// leaves in ascending leaf index, then its child labels in ascending label.
//
// Bound on the H100: latency.  The inputs and outputs are ~0.5 MB at
// Lp = 8192 (0.15 us at 3.35 TB/s); what takes time is the chains no
// parallel order may shorten: each label's fixed-order sum (up to Lp
// dependent adds in one label) and the EOM sweep over the labels in use (a
// label's subtree sum flips through its children's selection flags).  The
// design keeps those chains alone on the critical path and everything
// else parallel and on chip:
//   * a stable counting sort of the leaves by label (then of the child labels
//     by parent): each warp counts its contiguous segment's keys (__match_any
//     groups; a group's leader adds its size), one scan over (label, warp)
//     gives every group's first slot, and a second walk places each term,
//     (lambda - birth) * w, at its slot.  Each label's terms then lie
//     contiguously in leaf order;
//   * a warp per label folds its terms: coalesced loads a chunk ahead, the
//     adds in order on broadcast values (4 cycles each on one thread's chain);
//   * one thread walks EOM over the labels from n_labels - 1 down, its sums,
//     the stabilities, the child offsets and the parents in shared memory, the
//     next label's inputs read before the current one's store;
//   * blocking and resolution by pointer jumping over the labels (a parent's
//     label is below its children's) until no pointer moves: log2(depth) + 1
//     barrier rounds; ranks and the count by a block scan; the leaves' labels
//     by one gather.
// The arrays are placed on the device from the label count it reads there,
// in order: the EOM walk's (sums, stabilities, child offsets, parents), the
// leaf offsets, child terms and flags, the sort table, the sorted leaf terms;
// each in dynamic shared memory while it fits the block's 227 KB, else at its
// own offset in a scratch buffer the wrapper sizes for the largest label count.
// No float atomics and no reordered sums: two runs give the same bits.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemMax = 232448;  // dynamic shared memory one block may opt in to on sm_90
constexpr size_t kBuf = 256;  // block-scan partials at the front of shared memory

__host__ __device__ constexpr size_t round16(size_t b) { return (b + 15) & ~size_t(15); }

// Bytes of every array at the largest label count (n_slots labels); the
// scratch buffer's layout.  kernels/hierarchy.py::plan mirrors it.
__host__ __device__ constexpr size_t state_bytes(size_t Lp, size_t n_slots) {
  return 6 * round16(4 * n_slots) + round16(2 * n_slots) + round16(128 * n_slots) + round16(4 * Lp);
}

// Hands out the arrays in order: shared memory while an array fits what is
// left of `cap`, else its fixed place in the scratch layout.
struct Carve {
  unsigned char* smem;
  size_t used, cap;
  unsigned char* scratch;
  size_t offset;  // into the scratch layout, advanced by every array's largest size

  template <typename T>
  __device__ T* take(size_t count, size_t largest) {
    const size_t bytes = round16(count * sizeof(T));
    T* p;
    if (used + bytes <= cap) {
      p = reinterpret_cast<T*>(smem + used);
      used += bytes;
    } else {
      p = reinterpret_cast<T*>(scratch + offset);
    }
    offset += round16(largest * sizeof(T));
    return p;
  }
};

__device__ __forceinline__ int warp_inclusive_sum(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// In place exclusive prefix sum of a[0..m) by the whole block, a tile of
// kThreads elements at a time (one each); returns the total.  Ends on a
// barrier when m > 0.
__device__ int block_exclusive_scan(int* a, int m, int* sums) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int carry = 0;
  for (int base = 0; base < m; base += kThreads) {
    const int i = base + tid;
    const int v = i < m ? a[i] : 0;
    const int incl = warp_inclusive_sum(v, lane);
    if (lane == 31) sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int w = sums[lane];
      const int x = warp_inclusive_sum(w, lane);
      sums[lane] = x - w;
      if (lane == 31) sums[32] = x;
    }
    __syncthreads();
    if (i < m) a[i] = carry + sums[warp] + incl - v;
    carry += sums[32];
    __syncthreads();
  }
  return carry;
}

// The leaves: leaf j sits under label point_parent[j]; its term.
struct Leaves {
  const int* pp;
  const float *lam, *w, *birth;
  int n;
  __device__ int key(int j) const {
    const int k = pp[j];
    return static_cast<unsigned>(k) < static_cast<unsigned>(n) ? k : -1;
  }
  __device__ float term(int j, int k) const { return __fmul_rn(__fsub_rn(lam[j], birth[k]), w[j]); }
};

// The child labels 1 .. n - 1 (item j is label j + 1) under their parents.
struct Kids {
  const int* parent;
  const float *birth, *w;
  int n;
  __device__ int key(int j) const {
    const int k = parent[j + 1];
    return static_cast<unsigned>(k) < static_cast<unsigned>(n) ? k : -1;
  }
  __device__ float term(int j, int k) const { return __fmul_rn(__fsub_rn(birth[j + 1], birth[k]), w[j + 1]); }
};

// Stable counting sort of items 0 .. count - 1 by key (items whose key is
// not a label in use drop out): off[k] .. off[k + 1] holds label k's terms
// in item order.  table: 32 ints per label, (label, warp) major to minor.
// Warp w owns a contiguous segment of the items.  Ends on a barrier.
template <typename Items>
__device__ void sort_terms(const Items& items, int count, int n, int* table, int* off, float* out, int* sums) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t cells = size_t(n) * 32;
  for (size_t i = tid; i < cells; i += kThreads) table[i] = 0;
  __syncthreads();
  const int seg = (count + kThreads - 1) / kThreads * 32;
  const int lo = min(count, warp * seg), hi = min(count, lo + seg);
  for (int base = lo; base < hi; base += 32) {  // each group's size into its (label, warp) cell
    const int j = base + lane;
    const int k = j < hi ? items.key(j) : -1;
    const unsigned peers = __match_any_sync(kFull, k);
    if (k >= 0 && lane == __ffs(peers) - 1) table[size_t(k) * 32 + warp] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  for (int k = warp; k < n; k += kWarps) {  // exclusive over the warps of each label; the label's count
    int* row = table + size_t(k) * 32;
    const int v = row[lane];
    const int incl = warp_inclusive_sum(v, lane);
    row[lane] = incl - v;
    if (lane == 31) off[k] = incl;
  }
  __syncthreads();
  const int total = block_exclusive_scan(off, n, sums);
  if (tid == 0) off[n] = total;
  for (size_t i = tid; i < cells; i += kThreads) table[i] += off[i >> 5];
  __syncthreads();
  for (int base = lo; base < hi; base += 32) {  // the same groups again: each term to its slot
    const int j = base + lane;
    const int k = j < hi ? items.key(j) : -1;
    const unsigned peers = __match_any_sync(kFull, k);
    const int leader = __ffs(peers) - 1;
    int first = 0;
    if (k >= 0 && lane == leader) {
      int* cell = table + size_t(k) * 32 + warp;
      first = *cell;
      *cell = first + __popc(peers);
    }
    first = __shfl_sync(kFull, first, leader);
    if (k >= 0) out[first + __popc(peers & ((1u << lane) - 1u))] = items.term(j, k);
    __syncwarp();
  }
  __syncthreads();
}

// acc continued over a[lo .. hi) in order, one f32 add each, by one warp
// (lo, hi and acc the same on every lane; so is the result).
__device__ float warp_fold(const float* a, int lo, int hi, float acc, int lane) {
  float v = lo + lane < hi ? a[lo + lane] : 0.f;
  for (int base = lo; base < hi; base += 32) {
    const float next = base + 32 + lane < hi ? a[base + 32 + lane] : 0.f;
    if (hi - base >= 32) {
#pragma unroll
      for (int t = 0; t < 32; ++t) acc = __fadd_rn(acc, __shfl_sync(kFull, v, t));
    } else {
      for (int t = 0; t < hi - base; ++t) acc = __fadd_rn(acc, __shfl_sync(kFull, v, t));
    }
    v = next;
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads, 1)
extract_kernel(const int* __restrict__ point_parent, const float* __restrict__ point_lambda,
               const float* __restrict__ point_weight, const int* __restrict__ cluster_parent,
               const float* __restrict__ cluster_birth, const float* __restrict__ cluster_weight,
               const int* __restrict__ n_labels, int Lp, int n_slots, int leaf_method, int allow_single, size_t cap,
               void* scratch, float* __restrict__ stab_out, unsigned char* __restrict__ sel_out,
               int* __restrict__ labels_out, int* __restrict__ n_clusters_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* sums = reinterpret_cast<int*>(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = n_slots - 1;  // slot C is the trash label
  const int n = min(max(*n_labels, 0), C);
  const size_t N = n_slots;
  Carve cv{smem + kBuf, 0, cap, static_cast<unsigned char*>(scratch), 0};
  float* acc = cv.take<float>(n, N);  // EOM: the children's selected sums
  float* stab = cv.take<float>(n, N);
  int* koff = cv.take<int>(n + 1, N);  // label k's child terms at koff[k] .. koff[k + 1]
  int* par = cv.take<int>(n, N);  // each label's parent, -1 for the root and any parent not in use
  int* loff = cv.take<int>(n + 1, N);  // label k's leaf terms at loff[k] .. loff[k + 1]
  float* kterm = cv.take<float>(n, N);
  unsigned char* sel = cv.take<unsigned char>(2 * size_t(n), 2 * N);
  unsigned char* eff = sel + n;
  int* table = cv.take<int>(32 * size_t(n), 32 * N);  // the sorts' cells, then the jumping arrays
  float* lterm = cv.take<float>(Lp, Lp);

  for (int c = tid; c < n; c += kThreads) {
    const int p = c >= 1 ? cluster_parent[c] : -1;
    par[c] = static_cast<unsigned>(p) < static_cast<unsigned>(n) ? p : -1;
  }
  // stabilities: each label's leaf terms, then its child terms, in order (the sorts start on a barrier)
  sort_terms(Leaves{point_parent, point_lambda, point_weight, cluster_birth, n}, Lp, n, table, loff, lterm, sums);
  sort_terms(Kids{cluster_parent, cluster_birth, cluster_weight, n}, max(n - 1, 0), n, table, koff, kterm, sums);
  for (int c = warp; c < n; c += kWarps) {
    float s = warp_fold(lterm, loff[c], loff[c + 1], 0.f, lane);
    s = warp_fold(kterm, koff[c], koff[c + 1], s, lane);
    if (lane == 0) {
      stab[c] = s;
      stab_out[c] = s;
      acc[c] = 0.f;
    }
  }
  for (int c = n + tid; c <= C; c += kThreads) {
    stab_out[c] = 0.f;
    sel_out[c] = 0;
  }
  __syncthreads();

  // EOM: selected iff no children or stability >= the children's selected sum
  if (tid == 0 && n > 0) {
    int c = n - 1;
    float s = stab[c];
    int kids = koff[c + 1] - koff[c], p = par[c];
    for (; c >= 0; --c) {
      const float ksum = acc[c];
      float s_next = 0.f;
      int kids_next = 0, p_next = -1;
      if (c >= 1) {  // read ahead: no store of this step changes them
        s_next = stab[c - 1];
        kids_next = koff[c] - koff[c - 1];
        p_next = par[c - 1];
      }
      const bool is_sel = kids == 0 || s >= ksum;
      sel[c] = is_sel;
      if (p >= 0) acc[p] = __fadd_rn(acc[p], is_sel ? s : ksum);
      s = s_next;
      kids = kids_next;
      p = p_next;
    }
  }
  __syncthreads();

  int* ptr0 = table;  // four label arrays for the jumping, then the ranks and the resolved labels
  int* ptr1 = table + n;
  int* val0 = table + 2 * size_t(n);
  int* val1 = table + 3 * size_t(n);
  int* rank = table + 4 * size_t(n);
  int* resolved = table + 5 * size_t(n);
  auto allowed = [&](int c) { return sel[c] != 0 && (allow_single || c != 0); };
  if (leaf_method) {
    for (int c = tid; c < n; c += kThreads) eff[c] = koff[c + 1] == koff[c] && (allow_single || c != 0);
  } else {
    // blocked iff a proper ancestor is selected and allowed: an OR up the chain
    for (int c = tid; c < n; c += kThreads) {
      const int g = par[c];
      ptr0[c] = g;
      val0[c] = g >= 0 && allowed(g);
    }
    __syncthreads();
    for (int round = 0; round < 32; ++round) {
      int live = 0;
      for (int c = tid; c < n; c += kThreads) {
        const int g = ptr0[c];
        int v = val0[c], gg = -1;
        if (g >= 0) {
          v |= val0[g];
          gg = ptr0[g];
        }
        val1[c] = v;
        ptr1[c] = gg;
        live |= gg >= 0;
      }
      int* t = ptr0;
      ptr0 = ptr1;
      ptr1 = t;
      t = val0;
      val0 = val1;
      val1 = t;
      if (!__syncthreads_or(live)) break;
    }
    for (int c = tid; c < n; c += kThreads) eff[c] = allowed(c) && !val0[c];
  }
  int any = 0;
  for (int c = tid; c < n; c += kThreads) any |= eff[c];
  any = __syncthreads_or(any);
  if (allow_single && !any && tid == 0 && n > 0) eff[0] = 1;
  __syncthreads();

  // ranks; each label's nearest selected ancestor-or-self by pointer jumping
  for (int c = tid; c < n; c += kThreads) {
    rank[c] = eff[c];
    ptr0[c] = eff[c] ? c : par[c];
  }
  __syncthreads();
  const int n_clusters = block_exclusive_scan(rank, n, sums);
  for (int round = 0; round < 32; ++round) {
    int moved = 0;
    for (int c = tid; c < n; c += kThreads) {
      const int f = ptr0[c];
      const int g = f < 0 || eff[f] ? f : ptr0[f];
      ptr1[c] = g;
      moved |= g != f;
    }
    int* t = ptr0;
    ptr0 = ptr1;
    ptr1 = t;
    if (!__syncthreads_or(moved)) break;
  }
  for (int c = tid; c < n; c += kThreads) {
    const int f = ptr0[c];
    resolved[c] = f >= 0 && eff[f] ? rank[f] : -1;
    sel_out[c] = eff[c];
  }
  __syncthreads();
  for (int i = tid; i < Lp; i += kThreads) {
    const int k = point_parent[i];
    labels_out[i] = static_cast<unsigned>(k) < static_cast<unsigned>(n) ? resolved[k] : -1;
  }
  if (tid == 0) *n_clusters_out = n_clusters;
}

}  // namespace

// point_parent (Lp,) int32, point_lambda, point_weight (Lp,) f32;
// cluster_parent (n_slots,) int32, cluster_birth, cluster_weight (n_slots,)
// f32; n_labels () int32 on the device, read by the kernel (clamped to
// 0 .. n_slots - 1).  leaf_method: 0 EOM, 1 leaf.  Out: stability
// (n_slots,) f32, selected (n_slots,) bool, labels (Lp,) int32, n_clusters
// () int32.  scratch: repro_extract_scratch_bytes(Lp, n_slots) bytes
// (4-byte aligned), or null when that is 0.
extern "C" size_t repro_extract_scratch_bytes(int Lp, int n_slots) {
  const size_t state = state_bytes(Lp, n_slots);
  return kBuf + state <= static_cast<size_t>(kSmemMax) ? 0 : state;
}

extern "C" int repro_extract_f32(const void* point_parent, const void* point_lambda, const void* point_weight,
                                 const void* cluster_parent, const void* cluster_birth, const void* cluster_weight,
                                 const void* n_labels, int Lp, int n_slots, int leaf_method, int allow_single,
                                 void* scratch, void* stability, void* selected, void* labels, void* n_clusters,
                                 void* stream) {
  if (Lp < 1 || n_slots < 2 || (repro_extract_scratch_bytes(Lp, n_slots) > 0 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t state = state_bytes(Lp, n_slots), room = static_cast<size_t>(kSmemMax) - kBuf;
  const size_t cap = state < room ? state : room;
  const size_t smem = kBuf + cap;
  cudaError_t err = repro::allow_smem(extract_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  extract_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(point_parent), static_cast<const float*>(point_lambda),
      static_cast<const float*>(point_weight), static_cast<const int*>(cluster_parent),
      static_cast<const float*>(cluster_birth), static_cast<const float*>(cluster_weight),
      static_cast<const int*>(n_labels), Lp, n_slots, leaf_method, allow_single, cap, scratch,
      static_cast<float*>(stability), static_cast<unsigned char*>(selected), static_cast<int*>(labels),
      static_cast<int*>(n_clusters));
  return static_cast<int>(cudaGetLastError());
}
