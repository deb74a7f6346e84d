// Device-online ingest's CF scatter (kernels/flat_scatter.py): one block of
// rows folded into the flat leaf-CF table, in place.
//
// It stands for the segment sums and the compensated add of the JAX
// package's core/bubble_flat.py (_flat_insert and _flat_delete: three
// jax.ops.segment_sum calls, then _kahan_add), which run inside one jit with
// no Pallas kernel.  For every slot s of the bucket, with the rows of the
// block whose slot is s taken in ascending row order:
//   dLS[s] = sum x,  dSS[s] = sum |x|^2,  dN[s] = the count;
//   (LS, LSe)[s] += sign * dLS[s] and (SS, SSe)[s] += sign * dSS[s], each as
//   the compensated add t = hi + (delta - err), err = (t - hi) - (delta - err);
//   N[s] += sign * dN[s]; flags[s] = alive[s] && (insert ? N > thresh : N < thresh).
// Every slot gets the compensated add, a zero delta included: with err != 0
// it still moves both words, as the reference's whole-bucket add does.
//
// Bit for bit the plain version (kernels/ref.py::flat_scatter): no float
// atomics (the checkpoint replay of DESIGN.md §11 needs the same bits on
// every run), rows summed in ascending order from 0, |x|^2 as one rounded
// product per feature added in ascending feature order.  Every product and
// sum is an explicit round-to-nearest intrinsic (__fmul_rn, __fadd_rn,
// __fsub_rn), which nvcc never contracts into an FMA or reorders, so the
// source needs no -fmad=false.
//
// Bound on the H100: bytes, and at the stream's shapes a launch.  The state
// is read and written once (LS, LSe: Lp x d; SS, SSe, N: Lp) and the block
// read once: ~4.7 MB at Lp = 16384, Bp = 8192, d = 16, 1.4 us at 3.35 TB/s.
// Design: a warp owns a tile of T <= 32 consecutive slots and keeps their
// running sums in shared memory, so no two warps ever write one slot.  The
// block stages the rows' slot ids (8192 at a time, 32 KiB) once for its
// warps; each warp walks them 32 at a time, takes the rows of its tile with
// __ballot_sync in ascending order, and adds each with its lanes across the
// features.  Then the warp applies the compensated adds to its tile's
// contiguous rows, coalesced.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kChunk = 8192;      // slot ids staged per round (32 KiB)
constexpr int kWarps = 4;         // warps per block, at most
constexpr int kTile = 32;         // slots per warp, at most
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may use

__device__ __forceinline__ void kahan(float& hi, float& err, float delta) {
  const float y = __fsub_rn(delta, err);
  const float t = __fadd_rn(hi, y);
  err = __fsub_rn(__fsub_rn(t, hi), y);
  hi = t;
}

__global__ void flat_scatter_kernel(float* __restrict__ LS, float* __restrict__ LSe, float* __restrict__ SS,
                                    float* __restrict__ SSe, float* __restrict__ N,
                                    const unsigned char* __restrict__ alive, const float* __restrict__ X,
                                    const int* __restrict__ slot, const unsigned char* __restrict__ valid, int Bp,
                                    int Lp, int d, int T, float thresh, int sign,
                                    unsigned char* __restrict__ flags) {
  extern __shared__ float smem[];
  int* ids = reinterpret_cast<int*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int width = d + 2;  // per slot: d sums of x, the sum of |x|^2, the count
  float* acc = smem + kChunk + warp * T * width;
  const int base = (blockIdx.x * nwarps + warp) * T;
  for (int i = lane; i < T * width; i += 32) acc[i] = 0.f;
  __syncwarp();

  for (int c0 = 0; c0 < Bp; c0 += kChunk) {
    const int n = min(kChunk, Bp - c0);
    __syncthreads();  // every warp is done with the previous round's ids
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int s = slot[c0 + i];
      ids[i] = (valid[c0 + i] && s >= 0 && s < Lp) ? s : -1;
    }
    __syncthreads();
    for (int r0 = 0; r0 < n; r0 += 32) {
      const int s = r0 + lane < n ? ids[r0 + lane] : -1;
      const int t = s - base;
      unsigned mine = __ballot_sync(0xffffffffu, s >= 0 && t >= 0 && t < T);
      while (mine) {  // the tile's rows of these 32, in ascending order
        const int b = __ffs(mine) - 1;
        mine &= mine - 1;
        const int tb = __shfl_sync(0xffffffffu, t, b);
        const float* x = X + static_cast<size_t>(c0 + r0 + b) * d;
        float* a = acc + tb * width;
        for (int j = lane; j < d; j += 32) a[j] = __fadd_rn(a[j], x[j]);
        if (lane == 0) {
          float q = __fmul_rn(x[0], x[0]);
          for (int j = 1; j < d; ++j) q = __fadd_rn(q, __fmul_rn(x[j], x[j]));
          a[d] = __fadd_rn(a[d], q);
          a[d + 1] = __fadd_rn(a[d + 1], 1.f);
        }
      }
    }
  }
  __syncwarp();

  const int nslots = min(T, Lp - base);
  for (int i = lane; i < nslots * d; i += 32) {  // the tile's LS rows are contiguous
    const int t = i / d, j = i - t * d;
    const size_t e = static_cast<size_t>(base + t) * d + j;
    const float delta = acc[t * width + j];
    float hi = LS[e], err = LSe[e];
    kahan(hi, err, sign > 0 ? delta : -delta);
    LS[e] = hi;
    LSe[e] = err;
  }
  for (int t = lane; t < nslots; t += 32) {
    const int s = base + t;
    const float dss = acc[t * width + d], cnt = acc[t * width + d + 1];
    float hi = SS[s], err = SSe[s];
    kahan(hi, err, sign > 0 ? dss : -dss);
    SS[s] = hi;
    SSe[s] = err;
    const float m = sign > 0 ? __fadd_rn(N[s], cnt) : __fsub_rn(N[s], cnt);
    N[s] = m;
    flags[s] = alive[s] && (sign > 0 ? m > thresh : m < thresh);
  }
}

}  // namespace

// LS, LSe (Lp, d), SS, SSe, N (Lp,) f32, updated in place; alive (Lp,) bool;
// X (Bp, d) f32 centred rows, slot (Bp,) int32, valid (Bp,) bool (a row that
// is not valid, or whose slot lies outside [0, Lp), is dropped); thresh the
// work-list threshold; sign +1 (insert: flags = alive & N > thresh) or -1
// (delete: flags = alive & N < thresh).  Out: flags (Lp,) bool.
extern "C" int repro_flat_scatter_f32(void* LS, void* LSe, void* SS, void* SSe, void* N, const void* alive,
                                      const void* X, const void* slot, const void* valid, int Bp, int Lp, int d,
                                      float thresh, int sign, void* flags, void* stream) {
  if (Lp < 1 || d < 1 || Bp < 0 || (sign != 1 && sign != -1)) return static_cast<int>(cudaErrorInvalidValue);
  int warps = kWarps, T = kTile;
  auto bytes = [&] { return sizeof(int) * kChunk + sizeof(float) * warps * T * (static_cast<size_t>(d) + 2); };
  while (bytes() > kSmemMax && warps > 1) warps /= 2;
  while (bytes() > kSmemMax && T > 1) T /= 2;
  if (bytes() > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = repro::allow_smem(flat_scatter_kernel, bytes());
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_block = warps * T;
  flat_scatter_kernel<<<(Lp + per_block - 1) / per_block, warps * 32, bytes(), static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(LS), static_cast<float*>(LSe), static_cast<float*>(SS), static_cast<float*>(SSe),
      static_cast<float*>(N), static_cast<const unsigned char*>(alive), static_cast<const float*>(X),
      static_cast<const int*>(slot), static_cast<const unsigned char*>(valid), Bp, Lp, d, T, thresh, sign,
      static_cast<unsigned char*>(flags));
  return static_cast<int>(cudaGetLastError());
}
