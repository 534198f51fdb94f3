// Causal GQA flash attention for prefill on Hopper (sm_90a): bf16 in, fp32
// softmax and accumulation, bf16 out.
//
// Replaces the TPU kernel llm_consensus_tpu/ops/pallas/flash_attention.py
// (flash_attention, body _kernel): q [B, T, Hq, dh] against k/v
// [B, S, Hkv, dh]; query row r attends kv position p when
// p <= q_offset + r (and p > q_offset + r - window when windowed), with an
// optional logit softcap c * tanh(s / c); masked scores are -1e30, p is
// rounded to bf16 before P.V, and a row with l = 0 outputs 0.
//
// What bounds it on this card: at the main path's prefill shapes (T <= 512,
// dh 128 or 256, B 1 or 4) the work is ~4 * T * T/2 * dh FLOPs per head
// against one read of q/k/v and one write of o: a few microseconds at either
// peak, so in practice the latency of each CTA's serial kv sweep bounds it,
// and the longest sweep (the last causal q tile) sets the kernel's time.
//
// The design (FlashAttention-3's shape, written out in PTX):
//   * one CTA per (64 query rows, q head, batch row): one consumer warpgroup
//     and one producer warp, 80 KB of shared memory up to dh 128, so two CTAs
//     share an SM and one's softmax overlaps the other's tensor-core
//     products. (Measured on the card against two consumer warpgroups per
//     128 rows and against 128-row kv tiles: at T = 512 the causal sweep of
//     the last q tile is the kernel's critical path, and 64-row tiles halve
//     it.)
//   * dh 256 (gemma-7b) keeps that shape, re-derived: a tile row is 512
//     bytes (four 128-byte swizzle atoms), so Q is 32 KB and one K or V tile
//     of 64 rows 32 KB. Two stages of K and V take 128 KB: 161 KB in all,
//     one CTA to an SM (the 227 KB opt-in holds one; __launch_bounds__'s
//     min-blocks hint drops to 1 with it, which raises the register cap to
//     255). A third stage would fit (225 KB), but the simple kernel keeps
//     the ring it has; 32-row kv tiles would halve the ring but need m64n32
//     score products and twice the barrier round trips, and 64 rows keep
//     one tile shape for every width. Registers: O is a 128-float fragment a
//     thread, S 32 and P's A operand 16: under the 255 cap with room for
//     the addresses (ptxas -v in the build log reports spills). P.V is one
//     m64n256k16 a k-step, whose MN-major V descriptor steps over the four
//     atoms by its leading byte offset (one atom's 8 KB), as the dh-128
//     product steps over two.
//   * the producer warp loads the CTA's Q tile once and streams K/V tiles of
//     64 rows through a 2-stage shared-memory ring with TMA
//     (cp.async.bulk.tensor, 128-byte swizzle, 64-byte for dh 32) and
//     mbarriers, so the next tile's load overlaps this tile's products. The
//     tensor maps are built on the host per call (cuTensorMapEncodeTiled,
//     reached through cudaGetDriverEntryPoint, so the library links no
//     -lcuda) and passed as __grid_constant__ parameters, which CUDA graphs
//     capture by value. K/V maps end at s_eff, so TMA zero-fills the rows past
//     the causal frontier and never reads them;
//   * S = Q.K^T is wgmma.mma_async m64n64k16 with both operands in shared
//     memory; the online softmax runs on the S fragment in registers (exp2f
//     with scale * log2(e) folded in); P is converted to bf16 in registers
//     and is the register A operand of the P.V wgmma (m64n{dh}k16, V read
//     MN-major); O accumulates in registers, is rescaled there, and is
//     normalised once at the end. No S, P or O tile touches shared memory;
//   * causal scheduling: blockIdx.y runs the q tiles in reverse, so the
//     heaviest CTAs start first; the mask is applied only to tiles that cross
//     the diagonal, the window's edge or s_eff, and tiles wholly inside run
//     unmasked;
//   * GQA: blockIdx.x is the q head, so the G heads of a kv group are
//     adjacent CTAs of one q tile, launched together, and read the same K/V
//     tiles through L2. Packing the group into the M dimension instead would
//     make a 64-row tile hold 64 / G query positions, so the causal tiling
//     would change with G; ordering keeps one tile shape for every group.
//
// Translation from the TPU kernel: its sequential kv grid axis, which carried
// the softmax state in VMEM scratch, becomes the loop of the consumer
// warpgroup, with the state in registers.

#include <cuda.h>  // CUtensorMap and the driver enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 64;                       // query rows per CTA (one consumer warpgroup)
constexpr int kBN = 64;                         // kv rows per tile
constexpr int kStages = 2;                      // K/V ring depth
constexpr int kThreads = 128 + 32;              // the consumer warpgroup + the producer warp
constexpr float kNegInf = -1e30f;               // the TPU kernel's mask value
constexpr float kLog2e = 1.4426950408889634f;

template <int DH>
struct Tile {
  static constexpr int SW = DH * 2 >= 128 ? 128 : DH * 2;  // swizzle span in bytes
  static constexpr int INNER = SW / 2;                     // bf16 columns per swizzle atom
  static constexpr int ATOMS = DH / INNER;                 // atoms along dh
  static constexpr int Q_BYTES = kRows * DH * 2;           // the Q tile
  static constexpr int KV_BYTES = kBN * DH * 2;            // one K or V tile
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + Q_BYTES;
  static constexpr int V_OFF = K_OFF + kStages * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + kStages * KV_BYTES;
  static constexpr int BYTES = BAR_OFF + (2 * kStages + 1) * 8 + 1024;  // + alignment slack
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : 2;    // descriptor code: 128B / 64B swizzle
  // CTAs an SM holds (the __launch_bounds__ hint): two up to dh 128 (80 KB
  // each), one at dh 256 (161 KB), which also lifts the register cap from
  // ~200 to 255 a thread for its 128-register O fragment.
  static constexpr int MIN_BLOCKS = 2 * BYTES <= 232448 ? 2 : 1;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One TMA tile load of a 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets, swizzle layout code.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of wgmma accumulator
// registers across the asynchronous instructions that own them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The same for the bf16 A fragments that an asynchronous wgmma reads from
// registers until it completes.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (+)= A.B over k16: A [64 x 16] and B [64 x 16] both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D += A.B over k16: A [64 x 16] bf16 in registers, B [16 x 32] MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D += A.B over k16: A [64 x 16] bf16 in registers, B [16 x 64] MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D += A.B over k16: A [64 x 16] bf16 in registers, B [16 x 128] MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D += A.B over k16: A [64 x 16] bf16 in registers, B [16 x 256] MN-major in shared memory
// (the dh-256 P.V: the descriptor's leading byte offset steps over the four swizzle atoms).
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int DH>
__global__ void __launch_bounds__(kThreads, Tile<DH>::MIN_BLOCKS)
flash_prefill_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int T,
                     int s_eff, int Hq, int Hkv, int q_offset, int window, float softcap,
                     float scale) {
  using L = Tile<DH>;
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte alignment: the swizzle pattern repeats every 8 rows of 128 bytes.
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full_bar = base + L::BAR_OFF;            // kStages barriers: a K/V tile landed
  const uint32_t empty_bar = full_bar + 8 * kStages;      // kStages barriers: a stage was read
  const uint32_t q_bar = empty_bar + 8 * kStages;         // the Q tile landed

  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // heaviest causal tiles first
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q_end = min(q0 + kRows, T);
  // The CTA's kv tiles: up to the diagonal of its last row, from the window
  // of its first row.
  const int j_hi = min((s_eff - 1) / kBN, (q_offset + q_end - 1) / kBN);
  const int j_lo = window > 0 ? max(0, (q_offset + q0 - window + 1) / kBN) : 0;
  const int n_tiles = j_hi - j_lo + 1;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, 4);  // one arrival per consumer warp
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // Producer: one thread issues every TMA load of the CTA.
    if ((tid & 31) == 0) {
      mbar_expect_tx(q_bar, L::Q_BYTES);
      for (int a = 0; a < L::ATOMS; ++a) {
        tma_load(base + L::Q_OFF + a * kRows * L::SW, &tq, q_bar, a * L::INNER, h, q0, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(empty_bar + 8 * s, (i / kStages - 1) & 1);
        mbar_expect_tx(full_bar + 8 * s, 2 * L::KV_BYTES);
        const int kv0 = (j_lo + i) * kBN;
        for (int a = 0; a < L::ATOMS; ++a) {
          tma_load(base + L::K_OFF + s * L::KV_BYTES + a * kBN * L::SW, &tk, full_bar + 8 * s,
                   a * L::INNER, hk, kv0, b);
          tma_load(base + L::V_OFF + s * L::KV_BYTES + a * kBN * L::SW, &tv, full_bar + 8 * s,
                   a * L::INNER, hk, kv0, b);
        }
      }
    }
    return;
  }

  // The consumer warpgroup: this thread holds rows r0 and r0 + 8 of the
  // wgmma fragments.
  const int lane = tid & 31;
  const int quad = lane & 3;
  const int r0 = q0 + warp * 16 + (lane >> 2);
  const int abs0 = q_offset + r0;
  const int abs1 = abs0 + 8;
  const int first_row = q_offset + q0;  // absolute positions of the tile's rows
  const int last_row = first_row + kRows - 1;
  const uint32_t q_tile = base + L::Q_OFF;
  const float log2_scale = scale * kLog2e;

  float acc[DH / 2];  // O, m64n{DH} fragment
  float sc[kBN / 2];  // S, m64n{kBN} fragment
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) sc[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // running max, log2 units
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the running denominator

  mbar_wait(q_bar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    mbar_wait(full_bar + 8 * s, (i / kStages) & 1);
    const int kv0 = (j_lo + i) * kBN;
    const uint32_t k_tile = base + L::K_OFF + s * L::KV_BYTES;
    const uint32_t v_tile = base + L::V_OFF + s * L::KV_BYTES;

    // S = Q K^T: dh/16 k-steps, each 32 bytes into the current swizzle atom.
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t atom = (kk * 32) / L::SW, within = (kk * 32) % L::SW;
      const uint64_t da =
          make_desc(q_tile + atom * kRows * L::SW + within, 16, 8 * L::SW, L::LAYOUT);
      const uint64_t db =
          make_desc(k_tile + atom * kBN * L::SW + within, 16, 8 * L::SW, L::LAYOUT);
      wgmma_ss(sc, da, db, kk > 0 ? 1 : 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // Scores in log2 units: scale (and softcap) folded, masked to -1e30
    // only where the tile crosses the diagonal, the window's edge or s_eff.
    if (softcap > 0.f) {
#pragma unroll
      for (int i2 = 0; i2 < kBN / 2; ++i2) sc[i2] = softcap * tanhf(sc[i2] * scale / softcap) * kLog2e;
    } else {
#pragma unroll
      for (int i2 = 0; i2 < kBN / 2; ++i2) sc[i2] *= log2_scale;
    }
    const bool edge = kv0 + kBN - 1 > first_row || kv0 + kBN > s_eff ||
                      (window > 0 && kv0 <= last_row - window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kv0 + 8 * j + 2 * quad + (e & 1);
          const int row = e < 2 ? abs0 : abs1;
          bool ok = col <= row && col < s_eff;
          if (window > 0) ok = ok && col > row - window;
          if (!ok) sc[4 * j + e] = kNegInf;
        }
      }
    }
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      sc[4 * j] = exp2f(sc[4 * j] - mn0);
      sc[4 * j + 1] = exp2f(sc[4 * j + 1] - mn0);
      sc[4 * j + 2] = exp2f(sc[4 * j + 2] - mn1);
      sc[4 * j + 3] = exp2f(sc[4 * j + 3] - mn1);
      sum0 += sc[4 * j] + sc[4 * j + 1];
      sum1 += sc[4 * j + 2] + sc[4 * j + 3];
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      acc[4 * j] *= alpha0;
      acc[4 * j + 1] *= alpha0;
      acc[4 * j + 2] *= alpha1;
      acc[4 * j + 3] *= alpha1;
    }
    // P in bf16 as the A operand: k-step kk is S columns 16 kk .. 16 kk + 15.
    uint32_t pa[kBN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }

    // O += P V: V read MN-major, 16 kv rows per k-step.
    fence_regs(acc);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint64_t dv =
          make_desc(v_tile + kk * 16 * L::SW, kBN * L::SW, 8 * L::SW, L::LAYOUT);
      wgmma_rs(acc, pa[kk], dv);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(pa);
    if (lane == 0) mbar_arrive(empty_bar + 8 * s);  // this warp is done with the stage
  }

  // Normalise and store; a row with l = 0 outputs 0.
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = l0 == 0.f ? 0.f : 1.f / l0;
  const float inv1 = l1 == 0.f ? 0.f : 1.f / l1;
  const int64_t pitch = static_cast<int64_t>(Hq) * DH;
  __nv_bfloat16* o0 = o + (static_cast<int64_t>(b) * T + r0) * pitch + static_cast<int64_t>(h) * DH;
  __nv_bfloat16* o1 = o0 + 8 * pitch;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int c = 8 * j + 2 * quad;
    if (r0 < T) {
      *reinterpret_cast<__nv_bfloat162*>(o0 + c) =
          __floats2bfloat162_rn(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
    }
    if (r0 + 8 < T) {
      *reinterpret_cast<__nv_bfloat162*>(o1 + c) =
          __floats2bfloat162_rn(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
    }
  }
}

// cuTensorMapEncodeTiled, looked up once through the runtime.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A map of x [batch, rows_alloc, heads, DH] bf16 whose rows past `rows`
// read as zeros; boxes of (one swizzle atom of dh, 1 head, box_rows rows).
template <int DH>
bool make_map(CUtensorMap* map, const void* x, int batch, int rows, int rows_alloc, int heads,
              int box_rows) {
  using L = Tile<DH>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(DH), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(DH) * 2,
                                 static_cast<cuuint64_t>(heads) * DH * 2,
                                 static_cast<cuuint64_t>(rows_alloc) * heads * DH * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(L::INNER), 1,
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            L::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS;
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int T, int S,
                   int s_eff, int Hq, int Hkv, int q_offset, int window, float softcap,
                   float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map<DH>(&tq, q, B, T, T, Hq, kRows) || !make_map<DH>(&tk, k, B, s_eff, S, Hkv, kBN) ||
      !make_map<DH>(&tv, v, B, s_eff, S, Hkv, kBN)) {
    return cudaErrorInvalidValue;
  }
  const int bytes = Tile<DH>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_prefill_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(Hq, (T + kRows - 1) / kRows, B);
  flash_prefill_kernel<DH><<<grid, kThreads, bytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), T, s_eff, Hq, Hkv, q_offset, window, softcap,
      scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B, T, Hq, dh], k/v [B, S, Hkv, dh], o [B, T, Hq, dh]; all bf16 and
// contiguous, 16-byte aligned. s_eff = min(S, q_offset + T) bounds the kv
// sweep; window <= 0 disables the sliding window and softcap <= 0 the logit
// softcap. Returns the cudaError_t of the launch (0 on success).
int llmc_flash_attention_bf16(const void* q, const void* k, const void* v, void* o, int B,
                              int T, int S, int s_eff, int Hq, int Hkv, int dh, int q_offset,
                              int window, float softcap, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32:
      return launch<32>(q, k, v, o, B, T, S, s_eff, Hq, Hkv, q_offset, window, softcap,
                        scale, st);
    case 64:
      return launch<64>(q, k, v, o, B, T, S, s_eff, Hq, Hkv, q_offset, window, softcap,
                        scale, st);
    case 128:
      return launch<128>(q, k, v, o, B, T, S, s_eff, Hq, Hkv, q_offset, window, softcap,
                         scale, st);
    case 256:
      return launch<256>(q, k, v, o, B, T, S, s_eff, Hq, Hkv, q_offset, window, softcap,
                         scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* llmc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
