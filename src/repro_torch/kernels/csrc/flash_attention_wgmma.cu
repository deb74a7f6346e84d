// Forward attention with positional masks on Hopper's warpgroup tensor
// cores, bf16 only: the port of the JAX package's Pallas kernel
// repro/kernels/flash_attention.py::_flash_kernel (reached through
// pallas_call at :108), the tensor-core route of kernels/flash_attention.py.
// It computes what flash_attention_mma.cu (the mma.sync kernel it replaces,
// kept as the card's oracle) computes:
//   s = (q_r . k_c) / sqrt(D), or -1e30 where the key is dead (kpos < 0),
//   in the future (causal, kpos > qpos) or out of the window
//   (kpos <= qpos - window);  out_r = softmax(s) V in bf16;
// a row with no live key gets the uniform mean of V over the Sk keys, and
// where lse is given each row's log-sum-exp goes there (+inf without a live
// key).  Query head h reads kv head h / G; the layout comes in as strides.
//
// Bound on the H100: operations.  QK^T and PV take 4 D FLOPs per live
// (query, key) pair and head at 989 TFLOP/s dense bf16 (51.5 GFLOP, 52 us,
// for qwen2-1.5b's attention at S = 4096), while q, k, v and the output move
// 29 MB (9 us at 3.35 TB/s).  P enters PV as two bf16 terms (hi + lo, p to
// 2^-17; rounded once it is off by up to 2^-9 per weight, more than the
// port's attention check allows on rows with a few live keys whose values
// cancel), so the executed work is 6 D FLOPs per live pair: 77 GFLOP, a
// 78 us floor at S = 4096.  Everything below serves to keep the tensor cores
// fed at that rate:
// - wgmma (m64nNk16, f32 accumulators in registers) for both products, the
//   only way to the card's full tensor-core rate.  S = Q K^T reads Q and K
//   straight from shared memory through 128-byte-swizzled descriptors;
//   O += P V takes P from registers (the S accumulators are PV's A
//   fragments as they stand, so P never goes through shared memory) and V
//   from shared memory MN-major (the transpose flag): no ldmatrix, no
//   per-warp copy of any operand.
// - Blocks of 128 query rows per (batch x query head): two consumer
//   warpgroups of 64 rows each share every K/V tile, so a tile is read from
//   device memory once per 128 rows; keys go in tiles of kBK = 128.
// - One producer warpgroup (registers lowered to 40 by setmaxnreg, the
//   consumers raised to 232) whose first warp feeds a ring of K/V stages by
//   TMA (one thread, the hardware computes the addresses; full and empty
//   mbarriers), with each tile's kpos staged beside it.  TMA's
//   out-of-bounds zero fill pads D to DP in {64, 128} and the ragged tail of
//   Sq and Sk, so no copy carries a predicate.  While one consumer
//   warpgroup runs its softmax the other's products run, and the next tiles
//   are already in flight.  The ring holds 2 stages at DP = 128 (64 KB a
//   stage beside the 32 KB Q tile: a third does not fit in 227 KB) and 3
//   at DP = 64.  Issuing the next tile's Q K^T beside the softmax
//   (FlashAttention-3's intra-warpgroup overlap) spills at 128-key tiles
//   and gains nothing measurable at 64: kernels/flash_fwd_variants.py.
// - The tensor maps (D, S, heads, batch) are built on the host from the
//   strides with cuTensorMapEncodeTiled, fetched through
//   cudaGetDriverEntryPoint (no driver library at link time), and passed as
//   __grid_constant__ parameters.
// - The softmax runs on the accumulator layout in the log2 domain
//   (ex2.approx.ftz); masks are applied only on tiles where a warp can meet
//   a dead, future or out-of-window pair.  The producer pre-scans kpos and
//   loads only tiles in which some pair of the block can be live (the
//   consumers follow the tile index staged with each tile); rows that never
//   meet a live key take the mean of V from a separate sweep, so skipping
//   never changes a result.  Heavy (late) q blocks of every head launch
//   first.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 128;                 // query rows per block: two consumer warpgroups of 64
constexpr int kBK = 128;                 // keys per K/V tile
constexpr bool kSplit = true;            // P into PV as hi + lo bf16 terms
constexpr int kConsumers = 256;          // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kChunk = 512;              // tiles listed per pre-scan
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kBarProducer = 3;          // named barriers: 1 and 2 the consumer warpgroups, 3 the producer's

struct Strides {
  long long b, h, s;  // batch, head and sequence strides in elements; features are contiguous
};

struct Geometry {
  int BH, H, G, Sq, Sk, D, n_qblocks;
  Strides o;
  int causal, use_window, window;
  float scale;
  float* lse;  // (B, H, Sq) contiguous f32, or null
};

// Shared memory, in bytes from a 1024-byte-aligned base (the 128-byte
// swizzle repeats every 8 rows of 128 bytes).  A tile of R rows is DP / 64
// atoms of R rows x 64 columns (128 bytes a row), as TMA writes them.
template <int DP>
struct Smem {
  static constexpr int kStages = DP == 128 ? 2 : 3;  // K/V stages in the ring
  static constexpr int kAtoms = DP / 64;
  static constexpr int kQAtom = kBQ * 128;
  static constexpr int kKVAtom = kBK * 128;
  static constexpr int kKVBytes = kAtoms * kKVAtom;  // one K or one V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kAtoms * kQAtom;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kKpos = kV + kStages * kKVBytes;  // int [kStages][kBK]
  static constexpr int kTile = kKpos + 4 * kStages * kBK;  // int [kStages]: the tile each stage holds, -1 = end
  static constexpr int kList = kTile + 4 * kStages;       // int [kChunk]
  static constexpr int kRed = kList + 4 * kChunk;         // int [9]
  static constexpr int kMean = kRed + 4 * 10;             // float [2][DP]
  static constexpr int kBar = (kMean + 4 * 2 * DP + 7) / 8 * 8;  // u64: q, full_k[], full_v[], empty[]
  static constexpr int kBytes = kBar + 8 * (1 + 3 * kStages) + 1024;  // + the alignment slack
  static_assert(kBytes <= 232448, "shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// One arrival that also tells the barrier to expect `bytes` of TMA traffic.
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

// Wait until the barrier's phase with the given parity has completed.  A
// wait that cannot end (a fault in the pipeline) traps after ~2^28 polls,
// seconds at least, instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done, polls = 0;
  do {
    if (++polls == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// A (64 columns, rows, 1, 1) box of a 4-d tensor map into shared memory,
// completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap& map, uint32_t bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int n) { asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory"); }

// True on every thread of the 128 at named barrier `id` when any of them passes true.
__device__ __forceinline__ bool bar_any(bool x, int id) {
  uint32_t r;
  asm volatile(
      "{\n.reg .pred p, q;\n"
      "setp.ne.u32 p, %1, 0;\n"
      "bar.red.or.pred q, %2, 128, p;\n"
      "selp.u32 %0, 1, 0, q;\n}\n"
      : "=r"(r)
      : "r"(static_cast<uint32_t>(x)), "r"(id)
      : "memory");
  return r != 0;
}

// wgmma operand descriptor of a 128-byte-swizzled tile at `addr` (1024-byte
// aligned rows groups): lbo and sbo in bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>  // until at most N committed groups are in flight
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving register reads or writes across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(d[i][e])::"memory");
}

// S += A B, A and B from shared memory (K-major), m64n64k16 (64-key tiles: kernels/flash_fwd_variants.py);
// scale_d 0 starts from zero
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// S += A B, A and B from shared memory (K-major), m64n128k16; scale_d 0 starts from zero
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D += A B, A from registers, B from shared memory MN-major (transposed), m64n64k16
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D += A B, A from registers, B from shared memory MN-major (transposed), m64n128k16
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 rounded to bf16, the first in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (a, b) = hi + lo to 2^-17 relative, each term a bf16 pair packed as above.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(a, b);
  lo = pack_bf16(a - __uint_as_float(hi << 16), b - __uint_as_float(hi & 0xffff0000u));
}

__device__ __forceinline__ bool masked(int kp, int qp, const Geometry& g) {
  return kp < 0 || (g.causal && kp > qp) || (g.use_window && (long long)kp <= (long long)qp - g.window);
}

// The producer warpgroup lists, in list_s, the tiles [c0, c0 + kChunk) in
// which some (query, key) pair of the block can be live, and returns how
// many.  Call with all 128 producer threads; ends synchronised among them.
__device__ __forceinline__ int scan_tiles(const int* __restrict__ kp, int c0, int qmin, int qmax, const Geometry& g,
                                          int* list_s, int* count_s, int ptid) {
  const int lane = ptid & 31, warp = ptid >> 5;
  const int n_tiles = min(kChunk, (g.Sk + kBK - 1) / kBK - c0);
  for (int t = warp; t < n_tiles; t += 4) {
    const int key = (c0 + t) * kBK + lane;
    bool any = false;
#pragma unroll
    for (int j = 0; j < kBK / 32; ++j) {
      const int kv = key + 32 * j < g.Sk ? kp[key + 32 * j] : -1;
      any |= kv >= 0 && (!g.causal || kv <= qmax) && (!g.use_window || (long long)kv > (long long)qmin - g.window);
    }
    any = __any_sync(0xffffffffu, any);
    if (lane == 0) list_s[t] = any;
  }
  bar_sync(kBarProducer, 128);
  if (warp == 0) {  // compact in place: an entry moves only to a lower or equal slot
    int n = 0;
    for (int base = 0; base < n_tiles; base += 32) {
      const bool live = base + lane < n_tiles && list_s[base + lane];
      const unsigned ballot = __ballot_sync(0xffffffffu, live);
      if (live) list_s[n + __popc(ballot & ((1u << lane) - 1))] = c0 + base + lane;
      n += __popc(ballot);
    }
    if (lane == 0) *count_s = n;
  }
  bar_sync(kBarProducer, 128);
  return *count_s;
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmk,
                   const __grid_constant__ CUtensorMap tmv, const int* __restrict__ qpos,
                   const int* __restrict__ kpos, const bf16* __restrict__ v, long long vsb, long long vsh,
                   long long vss, bf16* __restrict__ out, Geometry g) {
  using L = Smem<DP>;
  constexpr int kStages = L::kStages, kAtoms = L::kAtoms;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  int* kpos_s = reinterpret_cast<int*>(smem + L::kKpos);
  int* tile_s = reinterpret_cast<int*>(smem + L::kTile);
  int* list_s = reinterpret_cast<int*>(smem + L::kList);
  int* red_s = reinterpret_cast<int*>(smem + L::kRed);
  float* mean_s = reinterpret_cast<float*>(smem + L::kMean);
  const uint32_t bar_q = base + L::kBar;
  auto bar_full_k = [&](int s) { return bar_q + 8 * (1 + s); };
  auto bar_full_v = [&](int s) { return bar_q + 8 * (1 + kStages + s); };
  auto bar_empty = [&](int s) { return bar_q + 8 * (1 + 2 * kStages + s); };

  const int tid = threadIdx.x;
  const int bh = blockIdx.x % g.BH;
  const int q0 = (g.n_qblocks - 1 - blockIdx.x / g.BH) * kBQ;  // heavy (late) blocks first
  const int b = bh / g.H, h = bh - b * g.H, kvh = h / g.G;
  const int* qp = qpos + (size_t)b * g.Sq;
  const int* kp = kpos + (size_t)b * g.Sk;
  const int rows = min(kBQ, g.Sq - q0);

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full_k(s), 32);  // the producer warp's lanes, each after staging its kpos
      mbar_init(bar_full_v(s), 1);
      mbar_init(bar_empty(s), kConsumers / 32);  // every consumer warp, after its products read the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer warpgroup: the tile pre-scan, then its first warp keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int ptid = tid - kConsumers, lane = ptid & 31, pw = ptid >> 5;
    const int qv = ptid < rows ? qp[q0 + ptid] : 0;
    const int wmin = __reduce_min_sync(0xffffffffu, ptid < rows ? qv : INT_MAX);
    const int wmax = __reduce_max_sync(0xffffffffu, ptid < rows ? qv : INT_MIN);
    if (lane == 0) {
      red_s[pw] = wmin;
      red_s[4 + pw] = wmax;
    }
    if (ptid == 0) {
      mbar_arrive_tx(bar_q, kAtoms * L::kQAtom);
#pragma unroll
      for (int a = 0; a < kAtoms; ++a) tma_load(base + L::kQ + a * L::kQAtom, tmq, bar_q, 64 * a, q0, h, b);
    }
    bar_sync(kBarProducer, 128);
    const int qmin = min(min(red_s[0], red_s[1]), min(red_s[2], red_s[3]));
    const int qmax = max(max(red_s[4], red_s[5]), max(red_s[6], red_s[7]));
    const int n_tiles = (g.Sk + kBK - 1) / kBK;
    int issued = 0;
    for (int c0 = 0;;) {
      const int n_live = scan_tiles(kp, c0, qmin, qmax, g, list_s, red_s + 8, ptid);
      if (pw == 0) {
        for (int i = 0; i < n_live; ++i, ++issued) {
          const int t = list_s[i], s = issued % kStages, k0 = t * kBK;
          mbar_wait(bar_empty(s), ((issued / kStages) & 1) ^ 1);
#pragma unroll
          for (int j = 0; j < kBK / 32; ++j) {
            const int key = k0 + lane + 32 * j;
            kpos_s[s * kBK + lane + 32 * j] = key < g.Sk ? kp[key] : -1;  // keys past Sk are dead
          }
          if (lane == 0) {
            tile_s[s] = t;
            mbar_arrive_tx(bar_full_k(s), L::kKVBytes);
#pragma unroll
            for (int a = 0; a < kAtoms; ++a)
              tma_load(base + L::kK + s * L::kKVBytes + a * L::kKVAtom, tmk, bar_full_k(s), 64 * a, k0, kvh, b);
            mbar_arrive_tx(bar_full_v(s), L::kKVBytes);
#pragma unroll
            for (int a = 0; a < kAtoms; ++a)
              tma_load(base + L::kV + s * L::kKVBytes + a * L::kKVAtom, tmv, bar_full_v(s), 64 * a, k0, kvh, b);
          } else {
            mbar_arrive(bar_full_k(s));
          }
        }
      }
      c0 += kChunk;
      if (c0 >= n_tiles) break;
      bar_sync(kBarProducer, 128);  // warp 0 is done with this chunk's list
    }
    if (pw == 0) {  // the end mark
      const int s = issued % kStages;
      mbar_wait(bar_empty(s), ((issued / kStages) & 1) ^ 1);
      if (lane == 0) tile_s[s] = -1;
      mbar_arrive(bar_full_k(s));
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = tid >> 7, lane = tid & 31, warp = (tid >> 5) & 3, quad = lane & 3;
    const int r0 = 64 * wg + 16 * warp + (lane >> 2), r1 = r0 + 8;  // this thread's rows in the block
    const int qp0 = r0 < rows ? qp[q0 + r0] : 0, qp1 = r1 < rows ? qp[q0 + r1] : 0;
    const int wqmin = __reduce_min_sync(0xffffffffu, min(r0 < rows ? qp0 : INT_MAX, r1 < rows ? qp1 : INT_MAX));
    const int wqmax = __reduce_max_sync(0xffffffffu, max(r0 < rows ? qp0 : INT_MIN, r1 < rows ? qp1 : INT_MIN));

    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    float m0 = kMasked, m1 = kMasked, l0 = 0.f, l1 = 0.f;  // l: this thread's share of the row sum
    const float sl = g.scale * kLog2e;                     // scores in the log2 domain
    const uint32_t q_base = base + L::kQ + wg * 64 * 128;  // this warpgroup's 64 rows of each Q atom

    float sc[kBK / 2];                                 // S, then P in f32: element 4j + e is row r0 (e < 2) or r1,
                                                       // key 8j + 2 quad + (e & 1)
    uint32_t ph[kBK / 16][4], pl[kBK / 16][4];         // P as hi + lo bf16 terms in the A fragment layout

    // S = Q K^T of the tile in stage s, issued (not waited for)
    auto issue_s = [&](int s) {
      const uint32_t k_base = base + L::kK + s * L::kKVBytes;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;  // 16 columns = 32 bytes a step within a 64-column atom
        wgmma_ss(sc, sw128_desc(q_base + (kk >> 2) * L::kQAtom + off, 16, 1024),
                 sw128_desc(k_base + (kk >> 2) * L::kKVAtom + off, 16, 1024), kk > 0);
      }
      wg_commit();
    };
    // O += P V of the tile in stage s, V MN-major: 16 keys (2048 bytes of every atom) a step; issued
    auto issue_pv = [&](int s) {
      const uint32_t v_base = base + L::kV + s * L::kKVBytes;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t dv = sw128_desc(v_base + kk * 16 * 128, L::kKVAtom, 1024);
        wgmma_rs(o, ph[kk], dv);
        if (kSplit) wgmma_rs(o, pl[kk], dv);
      }
      wg_commit();
    };
    // mask and scale S of the tile in stage s, then the online softmax: P in sc, the running (m, l) updated;
    // returns the rows' rescale factors for O
    auto softmax = [&](int s, float& corr0, float& corr1) {
      const int* kps = kpos_s + s * kBK;
      // is every (row, key) pair of this warp live?  Then no mask is needed.
      int kmin = INT_MAX, kmax = INT_MIN;
#pragma unroll
      for (int j = 0; j < kBK / 32; ++j) {
        const int kv = kps[lane + 32 * j];
        kmin = min(kmin, kv);
        kmax = max(kmax, kv);
      }
      kmin = __reduce_min_sync(0xffffffffu, kmin);
      kmax = __reduce_max_sync(0xffffffffu, kmax);
      const bool full = kmin >= 0 && (!g.causal || kmax <= wqmin) &&
                        (!g.use_window || (long long)kmin > (long long)wqmax - g.window);
      if (full) {
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) sc[i] *= sl;
      } else {
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
          const int2 kv = *reinterpret_cast<const int2*>(kps + 8 * j + 2 * quad);
          sc[4 * j + 0] = masked(kv.x, qp0, g) ? kMasked : sc[4 * j + 0] * sl;
          sc[4 * j + 1] = masked(kv.y, qp0, g) ? kMasked : sc[4 * j + 1] * sl;
          sc[4 * j + 2] = masked(kv.x, qp1, g) ? kMasked : sc[4 * j + 2] * sl;
          sc[4 * j + 3] = masked(kv.y, qp1, g) ? kMasked : sc[4 * j + 3] * sl;
        }
      }
      float mx0 = kMasked, mx1 = kMasked;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      corr0 = ex2(m0 - mn0);
      corr1 = ex2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        sc[4 * j + 0] = ex2(sc[4 * j + 0] - mn0);
        sc[4 * j + 1] = ex2(sc[4 * j + 1] - mn0);
        sc[4 * j + 2] = ex2(sc[4 * j + 2] - mn1);
        sc[4 * j + 3] = ex2(sc[4 * j + 3] - mn1);
        ls0 += sc[4 * j + 0] + sc[4 * j + 1];
        ls1 += sc[4 * j + 2] + sc[4 * j + 3];
      }
      l0 = l0 * corr0 + ls0;
      l1 = l1 * corr1 + ls1;
    };
    auto rescale_o = [&](float corr0, float corr1) {
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        o[4 * n + 0] *= corr0;
        o[4 * n + 1] *= corr0;
        o[4 * n + 2] *= corr1;
        o[4 * n + 3] *= corr1;
      }
    };
    auto split_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        split_bf16(sc[8 * kk + 0], sc[8 * kk + 1], ph[kk][0], pl[kk][0]);
        split_bf16(sc[8 * kk + 2], sc[8 * kk + 3], ph[kk][1], pl[kk][1]);
        split_bf16(sc[8 * kk + 4], sc[8 * kk + 5], ph[kk][2], pl[kk][2]);
        split_bf16(sc[8 * kk + 6], sc[8 * kk + 7], ph[kk][3], pl[kk][3]);
      }
    };
    auto fence_all = [&]() {
      fence_regs(ph);
      fence_regs(pl);
      fence_regs(o);
      wg_fence();
    };

    mbar_wait(bar_q, 0);
    for (int it = 0;; ++it) {
      const int s = it % kStages, parity = (it / kStages) & 1;
      mbar_wait(bar_full_k(s), parity);
      if (tile_s[s] < 0) break;
      wg_fence();
      issue_s(s);
      wg_wait<0>();
      fence_regs(sc);
      float corr0, corr1;
      softmax(s, corr0, corr1);
      rescale_o(corr0, corr1);
      split_p();
      mbar_wait(bar_full_v(s), parity);
      fence_all();
      issue_pv(s);
      wg_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(bar_empty(s));
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    // a row met a live key iff its running max left the masked value
    const bool live0 = m0 > kMasked, live1 = m1 > kMasked;
    float* vmean = mean_s + wg * DP;
    if (bar_any((r0 < rows && !live0) || (r1 < rows && !live1), 1 + wg)) {
      // rows without a live key: the uniform mean of V over every key
      const bf16* vh = v + b * vsb + kvh * vsh;
      for (int c = tid & 127; c < g.D; c += 128) {
        float sum = 0.f;
        for (long long key = 0; key < g.Sk; ++key) sum += __bfloat162float(vh[key * vss + c]);
        vmean[c] = sum / static_cast<float>(g.Sk);
      }
      bar_sync(1 + wg, 128);
    }
    if (g.lse != nullptr && quad == 0) {  // m is in the log2 domain: lse = (m + log2 l) ln 2
      float* lrow = g.lse + (size_t)bh * g.Sq + q0;
      if (r0 < rows) lrow[r0] = live0 ? (m0 + log2f(l0)) * kLn2 : INFINITY;
      if (r1 < rows) lrow[r1] = live1 ? (m1 + log2f(l1)) * kLn2 : INFINITY;
    }
    const float lc0 = fmaxf(l0, 1e-30f), lc1 = fmaxf(l1, 1e-30f);
    bf16* oh = out + b * g.o.b + h * g.o.h;
    bf16* orow0 = oh + (q0 + r0) * g.o.s;
    bf16* orow1 = oh + (q0 + r1) * g.o.s;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int c = 8 * n + 2 * quad;
      if (8 * n >= g.D) break;
      if (r0 < rows)
        *reinterpret_cast<uint32_t*>(orow0 + c) = live0 ? pack_bf16(__fdiv_rn(o[4 * n], lc0), __fdiv_rn(o[4 * n + 1], lc0))
                                                        : pack_bf16(vmean[c], vmean[c + 1]);
      if (r1 < rows)
        *reinterpret_cast<uint32_t*>(orow1 + c) = live1 ? pack_bf16(__fdiv_rn(o[4 * n + 2], lc1), __fdiv_rn(o[4 * n + 3], lc1))
                                                        : pack_bf16(vmean[c], vmean[c + 1]);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, or null.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                                           &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// The (D, S, heads, batch) map of a strided bf16 view, in boxes of 64
// columns x `rows` rows, 128-byte swizzle, zeros out of bounds.  The stride
// of an axis of length 1 is never used; it is replaced by one TMA takes.
bool make_map(CUtensorMap* map, const void* ptr, int D, int S, int heads, int B, long long sb, long long sh,
              long long ss, int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  auto stride = [](int n, long long st) { return (cuuint64_t)(n > 1 ? st * 2 : 16); };
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {stride(S, ss), stride(heads, sh), stride(B, sb)};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
int launch(const CUtensorMap& tmq, const CUtensorMap& tmk, const CUtensorMap& tmv, const int* qpos, const int* kpos,
           const void* v, long long vsb, long long vsh, long long vss, void* out, const Geometry& g,
           cudaStream_t stream) {
  const size_t smem = Smem<DP>::kBytes;
  auto kernel = flash_wgmma_kernel<DP>;
  const cudaError_t e = repro::allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<g.n_qblocks * g.BH, kThreads, smem, stream>>>(tmq, tmk, tmv, qpos, kpos, static_cast<const bf16*>(v),
                                                         vsb, vsh, vss, static_cast<bf16*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The tensor-core route of repro_flash_attention, with the arguments of
// repro_flash_attention_mma: q (B, H, Sq, D), k and v (B, KV, Sk, D), out
// (B, H, Sq, D) as strided bf16 views (dtype 1 only; element strides for
// batch, head and sequence, features contiguous); qpos (B, Sq) and kpos
// (B, Sk) contiguous int32.  H = KV * G, D <= 128 and a multiple of 8,
// every pointer 16-byte aligned and every stride of an axis longer than 1 a
// multiple of 8 elements (the caller checks those two: TMA needs them).
// lse: null, or (B, H, Sq) contiguous f32 for the rows' log-sum-exp.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// when a tensor map cannot be built.
extern "C" int repro_flash_attention_wgmma(int dtype, const void* q, const void* k, const void* v, const void* qpos,
                                           const void* kpos, void* out, void* lse, int B, int H, int KV, int Sq,
                                           int Sk, int D, long long qsb, long long qsh, long long qss, long long ksb,
                                           long long ksh, long long kss, long long vsb, long long vsh, long long vss,
                                           long long osb, long long osh, long long oss, int causal, int use_window,
                                           int window, float scale, void* stream) {
  const long long n_qblocks = (Sq + (long long)kBQ - 1) / kBQ;
  if (dtype != 1 || B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk <= 0 || D <= 0 || D > 128 ||
      D % 8 != 0 || n_qblocks * B * H > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tmq, tmk, tmv;
  if (!make_map(&tmq, q, D, Sq, H, B, qsb, qsh, qss, kBQ) || !make_map(&tmk, k, D, Sk, KV, B, ksb, ksh, kss, kBK) ||
      !make_map(&tmv, v, D, Sk, KV, B, vsb, vsh, vss, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  Geometry g{B * H, H, H / KV, Sq, Sk, D, static_cast<int>(n_qblocks), {osb, osh, oss}, causal, use_window, window,
             scale, static_cast<float*>(lse)};
  const auto* qp = static_cast<const int*>(qpos);
  const auto* kp = static_cast<const int*>(kpos);
  auto s = static_cast<cudaStream_t>(stream);
  if (D <= 64) return launch<64>(tmq, tmk, tmv, qp, kp, v, vsb, vsh, vss, out, g, s);
  return launch<128>(tmq, tmk, tmv, qp, kp, v, vsb, vsh, vss, out, g, s);
}
