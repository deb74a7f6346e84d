// The offline pass's hierarchy sweeps (kernels/hierarchy.py): single-linkage,
// condense, and the EOM sweep of flat extraction, one thread block each.
//
// They stand for the three lax.scans of the JAX package's
// core/hierarchy_jax.py (single-linkage, the top-down condense sweep, the
// bottom-up EOM sweep), which the reference runs inside one jit with no
// Pallas kernel.  The port's plain versions are the torch loops of
// core/hierarchy.py, and these kernels give their bits: every integer field,
// every lambda and every weight.
//
// Bound on the H100: latency.  Each sweep is a chain of dependent steps (a
// merge reads the components the merges before it made; a condense step reads
// the label its parent's step wrote; an EOM step reads the sums its children
// added), so the card's bandwidth and peak rates do not enter: at Lp = 8192
// the inputs and outputs are ~0.3 MB (0.1 us at 3.35 TB/s) while 8191 steps
// of even one dependent shared-memory access each take >= 0.1 ms.  The design
// keeps that chain short and in shared memory:
//   * one thread walks the steps in order; the other warps of the block stage
//     the next chunk of per-step inputs (edge ends and weights; a merge's
//     children, lambda and child weights) into a shared ring meanwhile, so the
//     walker never waits on device memory for them;
//   * the state the walker reads back lives in dynamic shared memory where it
//     fits the block's 227 KB (single-linkage and condense up to Lp = 16384,
//     EOM up to 8192), else in a global scratch buffer (L2-resident) the
//     wrapper allocates, in the same kernel;
//   * single-linkage is a union-find (union by size, path halving) whose root
//     carries the component's current internal node and weight.  The merge
//     records depend only on which component each edge end lies in and on
//     that component's node, never on which id names it, so this gives the
//     plain version's relabelling bits without its O(Lp) relabel per merge;
//     wsum = w(a) + w(b) is one round-to-nearest add, as in the plain loop.
// No float atomics and no reordered sums: two runs give the same bits.
// lambda = 1 / dist is the correctly rounded reciprocal (no fast math), and
// 1 / PAD_DIST = 1e-30 stays a normal f32.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kChunk = 1024;  // steps per staged chunk; the ring holds two
constexpr int kSmemMax = 232448;  // dynamic shared memory one block may opt in to on sm_90
constexpr float kMaxLambda = 1e12f;  // MAX_LAMBDA

__host__ __device__ constexpr size_t round4(size_t b) { return (b + 3) & ~size_t(3); }

// State bytes per kernel (in shared memory or the scratch buffer) and the
// staging ring's bytes; kernels/hierarchy.py::plan mirrors these.
__host__ __device__ constexpr size_t sl_state_bytes(int Lp) { return 12 * size_t(Lp); }
__host__ __device__ constexpr size_t cd_state_bytes(int Lp) { return 8 * size_t(Lp) + round4(Lp); }
__host__ __device__ constexpr size_t eom_state_bytes(int n_slots) { return 8 * size_t(n_slots); }
constexpr size_t kSlRing = 2 * kChunk * 12;  // u, v, w
constexpr size_t kCdRing = 2 * kChunk * 20;  // left, right, lambda, w_left, w_right

// Root of x's set; halves the path on the way.  Roots hold -size.
__device__ __forceinline__ int uf_find(int* parent, int x) {
  int p = parent[x];
  while (p >= 0) {
    const int gp = parent[p];
    if (gp < 0) return p;
    parent[x] = gp;
    x = gp;
    p = parent[x];
  }
  return x;
}

// ---------------------------------------------------------------------------
// single-linkage: M = Lp - 1 merges over the edges sorted by weight (stable);
// merge k joins the components of u[k] and v[k] into internal node Lp + k.

template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
single_linkage_kernel(const int* __restrict__ us, const int* __restrict__ vs, const float* __restrict__ ws,
                      const float* __restrict__ weights, int Lp, void* scratch, int* __restrict__ left,
                      int* __restrict__ right, float* __restrict__ dist, float* __restrict__ weight,
                      float* __restrict__ node_weight) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* ring_u = reinterpret_cast<int*>(smem);
  int* ring_v = ring_u + 2 * kChunk;
  float* ring_w = reinterpret_cast<float*>(ring_v + 2 * kChunk);
  unsigned char* state = kSmem ? smem + kSlRing : static_cast<unsigned char*>(scratch);
  int* parent = reinterpret_cast<int*>(state);  // -size at a root
  int* node_of_root = parent + Lp;  // the component's current node
  float* wroot = reinterpret_cast<float*>(node_of_root + Lp);  // and its weight
  const int tid = threadIdx.x;
  const int M = Lp - 1;
  const int trash = 2 * Lp - 1;

  for (int i = tid; i < Lp; i += blockDim.x) {
    const float w = weights[i];
    parent[i] = -1;
    node_of_root[i] = i;
    wroot[i] = w;
    node_weight[i] = w;
    node_weight[Lp + i] = 0.f;  // internal nodes of skipped merges, and the trash node, stay 0
  }
  auto stage = [&](int j, int lane0, int stride) {
    const int k0 = j * kChunk, cnt = min(kChunk, M - k0), b = (j & 1) * kChunk;
    for (int t = lane0; t < cnt; t += stride) {
      ring_u[b + t] = us[k0 + t];
      ring_v[b + t] = vs[k0 + t];
      ring_w[b + t] = ws[k0 + t];
    }
  };
  stage(0, tid, blockDim.x);
  __syncthreads();

  const int n_chunks = (M + kChunk - 1) / kChunk;
  for (int j = 0; j < n_chunks; ++j) {
    if (tid >= 32) {
      if (j + 1 < n_chunks) stage(j + 1, tid - 32, blockDim.x - 32);
    } else if (tid == 0) {
      const int k0 = j * kChunk, cnt = min(kChunk, M - k0), b = (j & 1) * kChunk;
      for (int t = 0; t < cnt; ++t) {
        const int k = k0 + t;
        const int ra = uf_find(parent, ring_u[b + t]);
        const int rb = uf_find(parent, ring_v[b + t]);
        const float wsum = __fadd_rn(wroot[ra], wroot[rb]);
        if (ra != rb) {
          left[k] = node_of_root[ra];
          right[k] = node_of_root[rb];
          dist[k] = ring_w[b + t];
          weight[k] = wsum;
          node_weight[Lp + k] = wsum;
          const int sa = parent[ra], sb = parent[rb];
          const int root = sa <= sb ? ra : rb;  // the larger set stays the root
          parent[root == ra ? rb : ra] = root;
          parent[root] = sa + sb;
          node_of_root[root] = Lp + k;
          wroot[root] = wsum;
        } else {  // both ends in one component: the row stays skipped, wsum lands on the trash node
          left[k] = trash;
          right[k] = trash;
          dist[k] = 0.f;
          weight[k] = 0.f;
          node_weight[trash] = wsum;
        }
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// condense: merge i (node Lp + i) from the root down.  Per internal node the
// state is (label, entry lambda, fallen); a leaf's label and lambda go
// straight to point_parent / point_lambda, which nothing reads back.

template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
condense_kernel(const int* __restrict__ left, const int* __restrict__ right, const float* __restrict__ dist,
                const float* __restrict__ node_weight, int Lp, float mcs, void* scratch,
                int* __restrict__ point_parent, float* __restrict__ point_lambda, int* __restrict__ cluster_parent,
                float* __restrict__ cluster_birth, float* __restrict__ cluster_weight, int* __restrict__ n_labels) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* ring_l = reinterpret_cast<int*>(smem);
  int* ring_r = ring_l + 2 * kChunk;
  float* ring_lam = reinterpret_cast<float*>(ring_r + 2 * kChunk);
  float* ring_wl = ring_lam + 2 * kChunk;
  float* ring_wr = ring_wl + 2 * kChunk;
  unsigned char* state = kSmem ? smem + kCdRing : static_cast<unsigned char*>(scratch);
  int* cl = reinterpret_cast<int*>(state);  // internal node Lp + i at [i]; [Lp - 1] is the trash node
  float* lam_in = reinterpret_cast<float*>(cl + Lp);
  unsigned char* fallen = reinterpret_cast<unsigned char*>(lam_in + Lp);
  const int tid = threadIdx.x;
  const int M = Lp - 1;
  const int C = 2 * Lp;  // label slots; slot C is the trash label

  for (int i = tid; i < Lp; i += blockDim.x) {
    cl[i] = 0;
    lam_in[i] = 0.f;
    fallen[i] = 0;
    point_parent[i] = 0;
    point_lambda[i] = 0.f;
  }
  for (int c = tid; c <= C; c += blockDim.x) {
    cluster_parent[c] = C;
    cluster_birth[c] = 0.f;
    cluster_weight[c] = c == 0 ? node_weight[2 * Lp - 2] : 0.f;  // the root's weight
  }
  // chunk j holds merges hi - 1, hi - 2, ... (hi = M - j * kChunk) in walking order
  auto stage = [&](int j, int lane0, int stride) {
    const int hi = M - j * kChunk, cnt = min(kChunk, hi), b = (j & 1) * kChunk;
    for (int t = lane0; t < cnt; t += stride) {
      const int i = hi - 1 - t;
      const int l = left[i], r = right[i];
      const float d = dist[i];
      ring_l[b + t] = l;
      ring_r[b + t] = r;
      ring_lam[b + t] = d > 0.f ? fminf(__frcp_rn(d), kMaxLambda) : kMaxLambda;
      ring_wl[b + t] = node_weight[l];
      ring_wr[b + t] = node_weight[r];
    }
  };
  stage(0, tid, blockDim.x);
  __syncthreads();

  int nxt = 1;
  const int n_chunks = (M + kChunk - 1) / kChunk;
  for (int j = 0; j < n_chunks; ++j) {
    if (tid >= 32) {
      if (j + 1 < n_chunks) stage(j + 1, tid - 32, blockDim.x - 32);
    } else if (tid == 0) {
      const int hi = M - j * kChunk, cnt = min(kChunk, hi), b = (j & 1) * kChunk;
      for (int t = 0; t < cnt; ++t) {
        const int i = hi - 1 - t;
        const int P = cl[i];
        const float lin = lam_in[i];
        const bool fal = fallen[i] != 0;
        const int l = ring_l[b + t], r = ring_r[b + t];
        const float lam = ring_lam[b + t], wl = ring_wl[b + t], wr = ring_wr[b + t];
        const bool hl = wl >= mcs && l >= Lp;  // heavy and internal
        const bool hr = wr >= mcs && r >= Lp;
        const bool both = hl && hr && !fal;
        const float child_lam = fal ? lin : lam;
        // a child stays live only if it founds a cluster or is the single continuing heavy side
        const int kid[2] = {l, r};
        const int label[2] = {both ? nxt : P, both ? nxt + 1 : P};
        const bool kid_fallen[2] = {fal || !(both || (hl && !hr)), fal || !(both || (hr && !hl))};
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int x = kid[s];
          if (x >= Lp) {
            cl[x - Lp] = label[s];
            lam_in[x - Lp] = child_lam;
            fallen[x - Lp] = kid_fallen[s];
          } else {
            point_parent[x] = label[s];
            point_lambda[x] = child_lam;
          }
        }
        if (both) {
          cluster_parent[nxt] = P;
          cluster_parent[nxt + 1] = P;
          cluster_birth[nxt] = lam;
          cluster_birth[nxt + 1] = lam;
          cluster_weight[nxt] = wl;
          cluster_weight[nxt + 1] = wr;
          nxt += 2;
        }
      }
    }
    __syncthreads();
  }
  if (tid == 0) *n_labels = nxt;
}

// ---------------------------------------------------------------------------
// EOM: labels n_labels - 1 down to 0 (a child's label exceeds its parent's,
// so its children are final when a label is visited); selected iff it has no
// children or its stability is at least its children's selected sum.

template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
eom_kernel(const float* __restrict__ stab, const int* __restrict__ parent, const int* __restrict__ n_labels,
           int n_slots, void* scratch, unsigned char* __restrict__ selected, int* __restrict__ kid_count) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* state = kSmem ? smem : static_cast<unsigned char*>(scratch);
  float* acc = reinterpret_cast<float*>(state);
  int* kids = reinterpret_cast<int*>(acc + n_slots);
  const int tid = threadIdx.x;
  for (int c = tid; c < n_slots; c += blockDim.x) {
    acc[c] = 0.f;
    kids[c] = 0;
    selected[c] = 0;
  }
  __syncthreads();
  if (tid == 0) {
    const int n = min(max(*n_labels, 0), n_slots - 1);
    for (int c = n - 1; c >= 0; --c) {
      const float s = stab[c], ksum = acc[c];
      const bool is_sel = kids[c] == 0 || s >= ksum;
      selected[c] = is_sel;
      if (c >= 1) {
        const int p = parent[c];
        acc[p] = __fadd_rn(acc[p], is_sel ? s : ksum);
        kids[p] += 1;
      }
    }
  }
  __syncthreads();
  for (int c = tid; c < n_slots; c += blockDim.x) kid_count[c] = kids[c];
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem > static_cast<size_t>(kSmemMax)) return cudaErrorInvalidValue;
  return repro::allow_smem(kernel, smem);
}

}  // namespace

// u, v (Lp,) int32 and w (Lp,) f32: the edge buffers sorted stably by
// weight, pad merges synthesized (kernels/hierarchy.py); weights (Lp,) f32.
// Out: left, right (Lp - 1,) int32, dist, weight (Lp - 1,) f32,
// node_weight (2 Lp,) f32.  use_smem: the union-find in shared memory
// (12 Lp bytes + the ring), else in scratch (12 Lp bytes, 4-byte aligned).
extern "C" int repro_single_linkage_f32(const void* u, const void* v, const void* w, const void* weights, int Lp,
                                        int use_smem, void* scratch, void* left, void* right, void* dist,
                                        void* weight, void* node_weight, void* stream) {
  if (Lp < 2 || Lp > (1 << 29) || (!use_smem && scratch == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = kSlRing + (use_smem ? sl_state_bytes(Lp) : 0);
  auto kernel = use_smem ? single_linkage_kernel<true> : single_linkage_kernel<false>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(u), static_cast<const int*>(v), static_cast<const float*>(w),
      static_cast<const float*>(weights), Lp, scratch, static_cast<int*>(left), static_cast<int*>(right),
      static_cast<float*>(dist), static_cast<float*>(weight), static_cast<float*>(node_weight));
  return static_cast<int>(cudaGetLastError());
}

// left, right (Lp - 1,) int32, dist (Lp - 1,) f32, node_weight (2 Lp,) f32
// from single-linkage.  Out: point_parent (Lp,) int32, point_lambda (Lp,)
// f32, cluster_parent (2 Lp + 1,) int32, cluster_birth, cluster_weight
// (2 Lp + 1,) f32, n_labels () int32.  use_smem: the node state in shared
// memory (9 Lp bytes rounded up to 4, + the ring), else in scratch.
extern "C" int repro_condense_f32(const void* left, const void* right, const void* dist, const void* node_weight,
                                  int Lp, float mcs, int use_smem, void* scratch, void* point_parent,
                                  void* point_lambda, void* cluster_parent, void* cluster_birth,
                                  void* cluster_weight, void* n_labels, void* stream) {
  if (Lp < 2 || Lp > (1 << 29) || (!use_smem && scratch == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = kCdRing + (use_smem ? cd_state_bytes(Lp) : 0);
  auto kernel = use_smem ? condense_kernel<true> : condense_kernel<false>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(left), static_cast<const int*>(right), static_cast<const float*>(dist),
      static_cast<const float*>(node_weight), Lp, mcs, scratch, static_cast<int*>(point_parent),
      static_cast<float*>(point_lambda), static_cast<int*>(cluster_parent), static_cast<float*>(cluster_birth),
      static_cast<float*>(cluster_weight), static_cast<int*>(n_labels));
  return static_cast<int>(cudaGetLastError());
}

// stab (n_slots,) f32, parent (n_slots,) int32 (cluster_parent), n_labels
// () int32 on the device, read by the kernel.  Out: selected (n_slots,)
// bool, kid_count (n_slots,) int32.  use_smem: the sums and child counts in
// shared memory (8 n_slots bytes), else in scratch.
extern "C" int repro_eom_f32(const void* stab, const void* parent, const void* n_labels, int n_slots, int use_smem,
                             void* scratch, void* selected, void* kid_count, void* stream) {
  if (n_slots < 1 || n_slots > (1 << 30) || (!use_smem && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = use_smem ? eom_state_bytes(n_slots) : 0;
  auto kernel = use_smem ? eom_kernel<true> : eom_kernel<false>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(stab), static_cast<const int*>(parent), static_cast<const int*>(n_labels), n_slots,
      scratch, static_cast<unsigned char*>(selected), static_cast<int*>(kid_count));
  return static_cast<int>(cudaGetLastError());
}
