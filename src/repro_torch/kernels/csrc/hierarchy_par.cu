// The offline pass's single-linkage and condense sweeps, redesigned for
// Hopper (kernels/hierarchy.py; the first versions, csrc/hierarchy.cu, are
// their bitwise oracle on the card).
//
// They stand for two lax.scans of the JAX package's core/hierarchy_jax.py
// (single-linkage and the top-down condense sweep), which the reference runs
// inside one jit with no Pallas kernel.  The bits are those of the plain
// loops of core/hierarchy.py (single_linkage_fixed, condense_fixed) in every
// field; core/hierarchy.py also holds numpy models of both algorithms below
// (single_linkage_chunked, condense_jump).
//
// Bound on the H100: latency.  The first versions walk every step with one
// thread (~465 and ~220 cycles a step at Lp = 8192).  Here:
//   * single-linkage keeps the merges in edge order (which component is
//     `left` and the operands of wsum = w(a) + w(b) are the loop's) but
//     takes the finds off the walk: per chunk of kChunk edges, every thread
//     finds the roots of one edge's two ends against the state at the
//     chunk's start (the forest does not change meanwhile, so flattening the
//     paths is the only write and every writer writes the same root); each
//     root takes the slot of one of its ends; one thread walks the chunk over
//     a union-find of those <= 2 kChunk slots in shared memory, each slot's
//     parent, node, weight and slot count in one 16-byte record; then every
//     thread writes the chunk's merge records out coalesced and links the
//     merged roots to the chunk's final roots.  The global state (parent,
//     node of a root) is read and written once per chunk, not once per step.
//     The walk is one warp's instruction latency (~110 cycles a step on the
//     H100; the parallel phases are ~5 us a chunk): it reads the next step's
//     parents before its own stores, corrects them by comparison, and keeps
//     to selects and one rarely taken branch (hierarchy_variants.py times
//     the alternatives).
//   * condense has no walk.  A node's parent merge has the larger id, and
//     over the path from the top down to node x: fallen(x) is the OR of the
//     per-edge drop flags (a child drops iff it is not heavy and internal);
//     entry lambda(x) is the lambda of the merge above the topmost drop, else
//     of x's parent merge; the label P(x) is the one x's nearest split
//     (both children heavy and internal, at a node that has not fallen) gave
//     its side, else 0; split i takes labels 1 + 2 #{splits j > i} and that
//     plus 1.  The merges go in chunks of kChunk from the top id down; a
//     chunk's parents are inside it or final, so pointer jumping over the
//     chunk in shared memory settles (fallen, topmost-drop lambda), a
//     block-wide suffix count numbers the splits, a second jumping settles P,
//     and one parallel pass writes every output.
// Every value is a copy, a comparison or the loop's one add: no float atomics
// and no reordered sums, so two runs give the same bits.  lambda = 1 / dist
// is the correctly rounded reciprocal (no fast math), clamped to MAX_LAMBDA.
// The per-node state lives in dynamic shared memory where it fits the
// block's 227 KB (single-linkage up to Lp = 16384, condense up to 8192),
// else in a global scratch buffer (L2-resident) the wrapper allocates.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kChunk = 1024;  // edges or merges per chunk: one per thread
constexpr int kSmemMax = 232448;  // dynamic shared memory one block may opt in to on sm_90
constexpr float kMaxLambda = 1e12f;  // MAX_LAMBDA

__host__ __device__ constexpr size_t round4(size_t b) { return (b + 3) & ~size_t(3); }

// Chunk buffers and per-node state bytes; kernels/hierarchy.py::plan mirrors these.
// single-linkage: 2 kChunk + 1 slot records and kChunk merge records (16 B each), the slots' roots, and each edge's
// two slots (8 B; +2 for the walk's look-ahead)
constexpr size_t kSlBuf = (3 * kChunk + 1) * 16 + 2 * kChunk * 4 + 2 * (kChunk + 2) * 4;
// condense: the two jumped values, the pointers and the labels of a chunk, and a count per warp
constexpr size_t kCdBuf = 4 * kChunk * 4 + (kThreads / 32) * 4;
__host__ __device__ constexpr size_t sl_state_bytes(int Lp) { return 8 * size_t(Lp); }
__host__ __device__ constexpr size_t cd_state_bytes(int Lp) { return 20 * size_t(Lp) + round4(2 * size_t(Lp)); }

__device__ __forceinline__ float merge_lambda(float d) { return d > 0.f ? fminf(__frcp_rn(d), kMaxLambda) : kMaxLambda; }

// Root of x in a forest that no thread links meanwhile; points every node of
// the path at the root.  Concurrent callers only write a node's own root, so
// any value read is an ancestor of the node.
__device__ __forceinline__ int find_flatten(volatile int* parent, int x) {
  int r = x, p = parent[x];
  while (p >= 0) {
    r = p;
    p = parent[r];
  }
  while (x != r) {
    const int nx = parent[x];
    if (nx == r) break;
    parent[x] = r;
    x = nx;
  }
  return r;
}

// ---------------------------------------------------------------------------
// single-linkage: M = Lp - 1 merges over the edges sorted by weight (stable);
// merge k joins the components of u[k] and v[k] into internal node Lp + k.

template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
single_linkage_par_kernel(const int* __restrict__ us, const int* __restrict__ vs, const float* __restrict__ ws,
                          const float* __restrict__ weights, int Lp, void* scratch, int* __restrict__ left,
                          int* __restrict__ right, float* __restrict__ dist, float* __restrict__ weight,
                          float* node_weight) {
  extern __shared__ __align__(16) unsigned char smem[];
  int4* rec = reinterpret_cast<int4*>(smem);  // per slot: (parent slot, node, weight bits, slot count)
  constexpr int kSpare = 2 * kChunk;  // a record no slot owns: a skipped step's record store lands there
  int4* out = rec + 2 * kChunk + 1;  // the chunk's merge records: (left, right, weight bits, skipped)
  int* gid = reinterpret_cast<int*>(out + kChunk);  // the root each slot's end found
  int2* ends = reinterpret_cast<int2*>(gid + 2 * kChunk);  // per edge: its ends' roots' slots, + 2 for the walk
  unsigned char* state = kSmem ? smem + kSlBuf : static_cast<unsigned char*>(scratch);
  int* parent = reinterpret_cast<int*>(state);  // a node's parent; at a root -1 - (its slot in the chunk)
  int* node_of = parent + Lp;  // a root's current internal node
  const int tid = threadIdx.x;
  const int M = Lp - 1;
  const int trash = 2 * Lp - 1;

  for (int i = tid; i < Lp; i += kThreads) {
    parent[i] = -1;
    node_of[i] = i;
    node_weight[i] = weights[i];
    node_weight[Lp + i] = 0.f;  // internal nodes of skipped merges, and the trash node, stay 0
  }
  int u = 0, v = 0;  // this thread's edge of the chunk
  float w = 0.f;
  if (tid < min(kChunk, M)) {
    u = us[tid];
    v = vs[tid];
    w = ws[tid];
  }
  float trash_w = 0.f;  // the walker's: wsum of the last skipped merge
  bool skipped = false;
  __syncthreads();

  const int n_chunks = (M + kChunk - 1) / kChunk;
  for (int j = 0; j < n_chunks; ++j) {
    const int k0 = j * kChunk, cnt = min(kChunk, M - k0);
    const bool mine = tid < cnt;
    int ru = 0, rv = 0;
    if (mine) {  // the ends' roots at the chunk's start
      ru = find_flatten(parent, u);
      rv = find_flatten(parent, v);
      gid[2 * tid] = ru;
      gid[2 * tid + 1] = rv;
    }
    __syncthreads();
    if (mine) {  // each root takes the slot of one of its ends: any writer wins
      parent[ru] = -1 - 2 * tid;
      parent[rv] = -2 - 2 * tid;
    }
    __syncthreads();
    int su = -1, sv = -1;
    if (mine) {  // every end reads its root's slot; the winning slots take the root's record
      su = -1 - parent[ru];
      sv = -1 - parent[rv];
      ends[tid] = make_int2(su, sv);
      if (su == 2 * tid) {
        const int nd = node_of[ru];
        rec[su] = make_int4(su, nd, __float_as_int(node_weight[nd]), 1);
      }
      if (sv == 2 * tid + 1) {
        const int nd = node_of[rv];
        rec[sv] = make_int4(sv, nd, __float_as_int(node_weight[nd]), 1);
      }
    }
    if (tid < 2) ends[cnt + tid] = make_int2(0, 0);  // the look-ahead past the chunk reads slot 0
    int nu = 0, nv = 0;  // the next chunk's edge, in flight during the walk
    float nw = 0.f;
    if (tid < min(kChunk, M - k0 - kChunk)) {
      nu = us[k0 + kChunk + tid];
      nv = vs[k0 + kChunk + tid];
      nw = ws[k0 + kChunk + tid];
    }
    __syncthreads();

    if (tid == 0) {  // the walk: the chunk's merges in edge order over the slots
      // One warp walks, so every instruction's latency shows: a step keeps to one record load per end, selects
      // and one rarely taken branch.  A step stores only the parents of its two ends and of the root it absorbs,
      // all its root, so the parents of step t + 1's ends are read during step t, before its stores, and
      // corrected by three comparisons each.
      int a0 = ends[0].x, b0 = ends[0].y, a1 = ends[1].x, b1 = ends[1].y;
      int pa = rec[a0].x, pb = rec[b0].x;  // this step's ends' parents, read before the step before's stores
      int e0 = -1, e1 = -1, e2 = -1, er = 0;  // the step before's ends and absorbed root, and its root
      int last = -1;  // the chunk's last skipped step
#pragma unroll 4
      for (int t = 0; t < cnt; ++t) {
        const int2 e = ends[t + 2];  // [cnt], [cnt + 1] hold slot 0
        const int na = rec[a1].x, nb = rec[b1].x;  // step t + 1's, before this step's stores
        int a = (a0 == e0 || a0 == e1 || a0 == e2) ? er : pa;
        int b = (b0 == e0 || b0 == e1 || b0 == e2) ? er : pb;
        int4 A = rec[a], B = rec[b];
        if (A.x != a || B.x != b) {  // a path of two hops or more
          while (A.x != a) {
            a = A.x;
            A = rec[a];
          }
          while (B.x != b) {
            b = B.x;
            B = rec[b];
          }
        }
        const float wsum = __fadd_rn(__int_as_float(A.z), __int_as_float(B.z));
        const bool keep_a = A.w >= B.w;  // the larger set stays the root
        const int root = keep_a ? a : b, other = keep_a ? b : a;
        const bool linked = a != b;  // else both ends in one component: the row stays skipped, wsum lands on trash
        out[t] = make_int4(A.y, B.y, __float_as_int(wsum), !linked);
        rec[other].x = root;
        rec[a0].x = root;  // the ends point at the root
        rec[b0].x = root;
        rec[linked ? root : kSpare] = make_int4(root, Lp + k0 + t, __float_as_int(wsum), A.w + B.w);
        last = linked ? last : t;
        e0 = a0;
        e1 = b0;
        e2 = other;
        er = root;
        a0 = a1;
        b0 = b1;
        a1 = e.x;
        b1 = e.y;
        pa = na;
        pb = nb;
      }
      if (last >= 0) {
        trash_w = __int_as_float(out[last].z);
        skipped = true;
      }
    }
    __syncthreads();

    if (mine) {  // the merge records out, coalesced; merged roots linked to the chunk's final roots
      const int k = k0 + tid;
      const int4 o = out[tid];
      const bool ok = o.w == 0 && o.x != trash;  // a skipped step: flag 1 (or left = trash)
      const float ww = ok ? __int_as_float(o.z) : 0.f;
      left[k] = ok ? o.x : trash;
      right[k] = ok ? o.y : trash;
      dist[k] = ok ? w : 0.f;
      weight[k] = ww;
      node_weight[Lp + k] = ww;
      const int slot[2] = {su, sv};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int s = 2 * tid + e;
        if (slot[e] != s) continue;  // another end holds this root's slot
        int f = s;
        while (rec[f].x != f) f = rec[f].x;
        if (f != s) {
          parent[gid[s]] = gid[f];
        } else {
          node_of[gid[s]] = rec[s].y;
        }
      }
    }
    u = nu;
    v = nv;
    w = nw;
    __syncthreads();
  }
  if (tid == 0 && skipped) node_weight[trash] = trash_w;
}

// ---------------------------------------------------------------------------
// condense: per-merge constants, then chunks of merges from the top id down.

template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
condense_par_kernel(const int* __restrict__ left, const int* __restrict__ right, const float* __restrict__ dist,
                    const float* __restrict__ node_weight, int Lp, float mcs, void* scratch,
                    int* __restrict__ point_parent, float* __restrict__ point_lambda,
                    int* __restrict__ cluster_parent, float* __restrict__ cluster_birth,
                    float* __restrict__ cluster_weight, int* __restrict__ n_labels) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_t = reinterpret_cast<float*>(smem);  // per chunk merge: topmost-drop lambda being jumped
  int* s_p = reinterpret_cast<int*>(s_t + kChunk);  // P being jumped
  int* s_ptr = s_p + kChunk;  // jump pointer (index in the chunk), -1 once final
  int* s_lab = s_ptr + kChunk;  // a split's first label, else -1
  int* s_warp = s_lab + kChunk;  // splits per warp
  unsigned char* state = kSmem ? smem + kCdBuf : static_cast<unsigned char*>(scratch);
  int* par = reinterpret_cast<int*>(state);  // parent merge of node Lp + i, -1 at a top node
  float* elam = reinterpret_cast<float*>(par + Lp);  // that merge's lambda
  float* fin_t = elam + Lp;  // topmost-drop lambda on node Lp + i's path, -1 where it has not fallen
  int* fin_p = reinterpret_cast<int*>(fin_t + Lp);  // P(node Lp + i)
  int* fin_lab = fin_p + Lp;  // split i's first label, -1 without a split
  unsigned char* edge = reinterpret_cast<unsigned char*>(fin_lab + Lp);  // node Lp + i drops (bit 0), is right (bit 1)
  unsigned char* both = edge + Lp;  // merge i: both children heavy and internal
  const int tid = threadIdx.x;
  const int M = Lp - 1;
  const int C = 2 * Lp;  // label slots; slot C is the trash label

  for (int i = tid; i < Lp; i += kThreads) {
    par[i] = -1;
    point_parent[i] = 0;
    point_lambda[i] = 0.f;
  }
  for (int c = tid; c <= C; c += kThreads) {
    cluster_parent[c] = C;
    cluster_birth[c] = 0.f;
    cluster_weight[c] = c == 0 ? node_weight[2 * Lp - 2] : 0.f;  // the root's weight
  }
  __syncthreads();
  // the per-merge constants; each internal child (not the trash node) learns its parent merge and whether it
  // drops there: (hl & hr) | (hl & !hr) is hl, so a child drops iff it is not heavy and internal
  for (int i = tid; i < M; i += kThreads) {
    const int l = left[i], r = right[i];
    const float lam = merge_lambda(dist[i]);
    const bool hl = node_weight[l] >= mcs && l >= Lp;
    const bool hr = node_weight[r] >= mcs && r >= Lp;
    both[i] = hl && hr;
    if (l >= Lp && l < 2 * Lp - 1) {
      par[l - Lp] = i;
      elam[l - Lp] = lam;
      edge[l - Lp] = !hl;
    }
    if (r >= Lp && r < 2 * Lp - 1) {
      par[r - Lp] = i;
      elam[r - Lp] = lam;
      edge[r - Lp] = (!hr) | 2;
    }
  }
  __syncthreads();

  int above = 0;  // splits among the merges already final (the same count in every thread)
  const int lane = tid & 31, warp = tid >> 5;
  for (int hi = M; hi > 0; hi -= kChunk) {
    const int lo = max(0, hi - kChunk), i = lo + tid;
    const bool mine = i < hi;
    const int p = mine ? par[i] : -1;  // p > i >= lo: inside the chunk iff p < hi
    const unsigned char e = mine ? edge[i] : 0;

    // fallen and the topmost drop's lambda: the upper value wins
    float t_val = -1.f;
    int ptr = -1;
    if (p >= 0) {
      const float et = (e & 1) ? elam[i] : -1.f;
      if (p >= hi) {
        const float ft = fin_t[p];
        t_val = ft >= 0.f ? ft : et;
      } else {
        t_val = et;
        ptr = p - lo;
      }
    }
    s_t[tid] = t_val;
    s_ptr[tid] = ptr;
    while (__syncthreads_or(ptr >= 0)) {
      float qt = 0.f;
      int qp = -1;
      if (ptr >= 0) {
        qt = s_t[ptr];
        qp = s_ptr[ptr];
      }
      __syncthreads();
      if (ptr >= 0) {
        if (qt >= 0.f) t_val = qt;
        ptr = qp;
        s_t[tid] = t_val;
        s_ptr[tid] = ptr;
      }
    }
    if (mine) fin_t[i] = t_val;

    // the splits, numbered by a suffix count: labels run from the top id down
    const bool split = mine && both[i] && !(t_val >= 0.f);
    const unsigned bits = __ballot_sync(0xffffffffu, split);
    if (lane == 0) s_warp[warp] = __popc(bits);
    __syncthreads();
    int after = lane == 31 ? 0 : __popc(bits >> (lane + 1)), total = 0;
    for (int w2 = 0; w2 < kThreads / 32; ++w2) {
      const int c = s_warp[w2];
      total += c;
      if (w2 > warp) after += c;
    }
    const int lab = split ? 1 + 2 * (above + after) : -1;
    above += total;
    s_lab[tid] = lab;
    if (mine) fin_lab[i] = lab;
    __syncthreads();

    // P: the nearest split's label wins
    int p_val = 0;
    ptr = -1;
    if (p >= 0) {
      const int pl = p >= hi ? fin_lab[p] : s_lab[p - lo];
      if (pl >= 0) {
        p_val = pl + (e >> 1);
      } else if (p >= hi) {
        p_val = fin_p[p];
      } else {
        p_val = -1;
        ptr = p - lo;
      }
    }
    s_p[tid] = p_val;
    s_ptr[tid] = ptr;
    while (__syncthreads_or(ptr >= 0)) {
      int qv = 0, qp = -1;
      if (ptr >= 0) {
        qv = s_p[ptr];
        qp = s_ptr[ptr];
      }
      __syncthreads();
      if (ptr >= 0) {
        p_val = qv;
        ptr = qv >= 0 ? -1 : qp;
        s_p[tid] = p_val;
        s_ptr[tid] = ptr;
      }
    }
    if (mine) fin_p[i] = p_val;
  }
  __syncthreads();

  // the outputs: labels founded by each split, and the leaves' label and entry lambda
  for (int i = tid; i < M; i += kThreads) {
    const int l = left[i], r = right[i], lab = fin_lab[i], P = fin_p[i];
    const float lam = merge_lambda(dist[i]), t = fin_t[i];
    if (lab >= 0) {
      cluster_parent[lab] = P;
      cluster_parent[lab + 1] = P;
      cluster_birth[lab] = lam;
      cluster_birth[lab + 1] = lam;
      cluster_weight[lab] = node_weight[l];
      cluster_weight[lab + 1] = node_weight[r];
    }
    const float lam_in = t >= 0.f ? t : lam;  // a split has no leaf child, so a leaf's label is P
    if (l < Lp) {
      point_parent[l] = P;
      point_lambda[l] = lam_in;
    }
    if (r < Lp) {
      point_parent[r] = P;
      point_lambda[r] = lam_in;
    }
  }
  if (tid == 0) *n_labels = 1 + 2 * above;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem > static_cast<size_t>(kSmemMax)) return cudaErrorInvalidValue;
  return repro::allow_smem(kernel, smem);
}

}  // namespace

// As repro_single_linkage_f32 (csrc/hierarchy.cu): u, v (Lp,) int32 and w
// (Lp,) f32, the edge buffers sorted stably by weight with the pad merges
// synthesized; weights (Lp,) f32.  Out: left, right (Lp - 1,) int32, dist,
// weight (Lp - 1,) f32, node_weight (2 Lp,) f32.  use_smem: the parent and
// node-of-root arrays in shared memory (8 Lp bytes + the chunk buffers),
// else in scratch (8 Lp bytes).
extern "C" int repro_single_linkage_par_f32(const void* u, const void* v, const void* w, const void* weights,
                                            int Lp, int use_smem, void* scratch, void* left, void* right,
                                            void* dist, void* weight, void* node_weight, void* stream) {
  if (Lp < 2 || Lp > (1 << 29) || (!use_smem && scratch == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = kSlBuf + (use_smem ? sl_state_bytes(Lp) : 0);
  auto kernel = use_smem ? single_linkage_par_kernel<true> : single_linkage_par_kernel<false>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(u), static_cast<const int*>(v), static_cast<const float*>(w),
      static_cast<const float*>(weights), Lp, scratch, static_cast<int*>(left), static_cast<int*>(right),
      static_cast<float*>(dist), static_cast<float*>(weight), static_cast<float*>(node_weight));
  return static_cast<int>(cudaGetLastError());
}

// As repro_condense_f32 (csrc/hierarchy.cu): left, right (Lp - 1,) int32,
// dist (Lp - 1,) f32, node_weight (2 Lp,) f32 from single-linkage.  Out:
// point_parent (Lp,) int32, point_lambda (Lp,) f32, cluster_parent
// (2 Lp + 1,) int32, cluster_birth, cluster_weight (2 Lp + 1,) f32, n_labels
// () int32.  use_smem: the per-node state in shared memory (22 Lp bytes
// rounded up to 4, + the chunk buffers), else in scratch.
extern "C" int repro_condense_par_f32(const void* left, const void* right, const void* dist, const void* node_weight,
                                      int Lp, float mcs, int use_smem, void* scratch, void* point_parent,
                                      void* point_lambda, void* cluster_parent, void* cluster_birth,
                                      void* cluster_weight, void* n_labels, void* stream) {
  if (Lp < 2 || Lp > (1 << 29) || (!use_smem && scratch == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = kCdBuf + (use_smem ? cd_state_bytes(Lp) : 0);
  auto kernel = use_smem ? condense_par_kernel<true> : condense_par_kernel<false>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(left), static_cast<const int*>(right), static_cast<const float*>(dist),
      static_cast<const float*>(node_weight), Lp, mcs, scratch, static_cast<int*>(point_parent),
      static_cast<float*>(point_lambda), static_cast<int*>(cluster_parent), static_cast<float*>(cluster_birth),
      static_cast<float*>(cluster_weight), static_cast<int*>(n_labels));
  return static_cast<int>(cudaGetLastError());
}
