// One-token GQA decode attention over one layer of the layer-stacked KV
// cache, on Hopper (sm_90a): bf16 q in, fp32 softmax and accumulation, bf16
// out, over a bf16 cache or an int8 cache.
//
// Replaces the TPU kernel llm_consensus_tpu/ops/pallas/decode_attention.py
// (decode_attention, body _kernel): q [B, 1, Hq, dh] against layer `layer`
// of the cache. Row b attends slots row_start[b] <= p <= pos (and
// p > pos - window when windowed) inside the static span kv_width;
// optional logit softcap. pos, layer and row_start live in device memory,
// so one build serves every step and every layer with no host sync, and the
// layer is addressed by offset into the stacks: no slice, no copy.
//
// Three variants, one kernel body (decode_body<DH, Cache>):
//   * bf16 cache k/v [L, B, S, Hkv, dh] (decode_bf16_kernel; the TPU kernel's
//     dense-cache body): scores = q . k x scale, softcap, mask, online
//     softmax, P (bf16) . V;
//   * int8 cache (decode_q8_kernel<DH, false>; the TPU kernel's
//     _qstruct_block, :268, with _qstruct_tail): codes [L, B, S, Hkv, dh]
//     int8 and per-slot scales [L, B, Hkv, S] bf16 (seq-minor). Scores =
//     (q . k_codes) x K scale x scale, with q in bf16 and the codes cast to
//     bf16 (both exact, fp32 accumulation); then softcap and mask; m and l
//     come from the unscaled p; then p is multiplied by the slot's V scale
//     (a select, 0 outside [lo, hi], so NaN scales past the frontier never
//     count), rounded to bf16, and P.V runs on the V codes cast to bf16. No
//     dequantized K/V exists;
//   * int8 cache with int8 x int8 scores (decode_q8_kernel<DH, true>; the
//     TPU kernel's _qstruct_w8a8_block, :245): each CTA quantizes its query
//     heads per head over dh, as ops/quant.quantize_rows_sym (scale =
//     max(amax * (1/127), 1e-30), codes = clamp(rint(q / scale), +-127)); a
//     score is the exact int32 dot of q codes and K codes, times the q scale,
//     the K scale and `scale`; the rest as the int8 variant.
//
// What bounds it on this card: bytes. A step reads the valid K/V rows of
// one layer once (bf16: 4 * n_valid * Hkv * dh bytes; int8: half that plus
// 4 * n_valid * Hkv bytes of scales) and does ~4 operations per element
// read, far below the ~295 FLOPs/byte ridge. At batch 1 the TPU kernel's
// one-program-per-(row, kv head) form would occupy 8 of 132 SMs, so the kv
// span is split (flash-decoding). At the main path's widths (a few hundred
// slots) the bytes take well under a microsecond, so latency bounds the
// kernel: launches, dependent loads, barriers. The design answers both:
//   * one launch per call. Each CTA (split, kv head, row) writes an fp32
//     partial (m, l, acc) and takes a ticket (__threadfence, then atomicAdd
//     on an int32 per (row, kv head)); the last CTA to arrive merges the
//     partials exactly (o = sum_i w_i acc_i / sum_i w_i l_i, w_i =
//     exp(m_i - m)) with independent 16-byte loads spread over split lanes,
//     and resets its ticket to 0, so the next launch and a CUDA-graph replay
//     find it zero. With one split the CTA writes the output directly;
//   * a split plan made on the host from the shape (ops/kernels/
//     decode_attention.split_plan): at most one CTA per SM in all, so every
//     CTA runs in the first wave, and no split shorter than 256 slots (one
//     merge round trip costs more than a shorter split saves: measured over
//     the int8 cache too, whose slots carry half the bytes, at 128, 256 and
//     512), so the split count follows the width and the batch;
//   * each CTA streams its split's valid slots in 128-slot chunks (64 at
//     dh 256: Geom below) through a 3-stage cp.async ring (zero-fill for the
//     rows outside [row_start, pos] and the window: they are never read, and
//     NaN there cannot reach the output), so chunk loads overlap scoring.
//     An int8 stage also holds the chunk's K and V scale runs (contiguous:
//     the layout is seq-minor), copied in 16-byte pieces from the 16-byte
//     boundary at or before the chunk's first slot, since a split or chunk
//     may start at any slot and S need not be a multiple of 8; the kernel
//     reads them from that offset.
//     With one CTA to an SM, eight warps (16 slots each per chunk; four at
//     dh 256) hide the latency of each warp's dependent products;
//   * tensor-core arithmetic on registers: the kv head's G <= 16 query heads
//     are the 16 rows of an mma.sync A operand loaded once (zero past G;
//     held in registers, at dh 256 in shared memory);
//     each warp scores 16 slots of a chunk, keeps its online softmax and its
//     O fragment in registers across chunks, and feeds P (bf16) back as the
//     A operand of P.V (m16n8k16). bf16 reads K with ldmatrix and V with
//     ldmatrix.trans. int8 K: an ldmatrix of code rows read as b16 gives a
//     thread 4 consecutive codes of one slot, which is the B layout of the
//     int8 m16n8k32 (W8A8: q codes are its A operand, the int32 dot is
//     exact); the int8 variant converts them to two bf16 pairs in registers
//     (exact for |c| <= 128) for m16n8k16 and permutes the columns of q's A
//     fragment to match, since the dh contraction does not care about order.
//     int8 V: ldmatrix.trans works on 16-bit elements only, so P.V permutes
//     its output columns instead: thread group g owns dh g * dh/8 + n of
//     n8-tile n, a contiguous run of each of its four slot rows, read with
//     one vector load per row and paired across neighbouring slots with
//     __byte_perm before the conversion. The warps merge once, through
//     shared memory, at the end.
//
// return_state (every variant; the TPU kernel's return_state=True, for the
// shared-prefix decode path's two-source merge): whichever code merges the
// splits holds each (row, query head)'s global softmax state, so when
// m_out/l_out are non-null it writes it beside the output, fp32 [B, Hq], in
// the same launch: m = the max of the scaled, softcapped, masked scores;
// l = the sum of exp(s - m) over valid slots, taken before the int8 V scale
// folds into p. A row with no valid slot writes m = -1e30 and l = 0. The
// output is the bf16-rounded normalized attention, as the TPU kernel's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

enum class Cache { kBf16, kInt8, kW8A8 };

constexpr int kStages = 3;                // cp.async ring depth
constexpr int kMaxGroup = 16;             // query heads per kv head
constexpr int kMaxSplit = 512;            // splits per (row, kv head) the fused merge holds
constexpr int kMaxDevices = 64;           // devices whose shared-memory opt-in is remembered
constexpr float kNegInf = -1e30f;         // the TPU kernel's mask value
constexpr float kLog2e = 1.4426950408889634f;

// The CTA's shape by head width. Up to dh 128: eight warps of 16 slots, so a
// ring chunk is 128 slots. At dh 256 a bf16 slot row is 528 bytes and three
// stages of 128-slot K and V chunks (405,504 bytes) would not fit the opt-in:
// four warps halve the chunk to 64 slots, three stages then take 202,752
// bytes (the int8 ring 105,312), and the merge buffer, whose warp O and
// split-lane sums shrink with the warps, takes 132,736 bytes at kMaxSplit:
// with the static arrays (8.5 KB at most) under the 232,448-byte opt-in.
// There the O fragment alone is 128 registers a thread, so the CTA also
// keeps q's A fragments in shared memory, read per k-step (64 registers not
// held), and converts int8 V one 32-bit word at a time inside P.V instead of
// all of it before the scores (64 more).
template <int DH>
struct Geom {
  static constexpr int WARPS = DH > 128 ? 4 : 8;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int CHUNK = 16 * WARPS;     // kv slots per ring chunk: 16 per warp
  static constexpr int SCALE_RUN = CHUNK + 8;  // scales a stage holds: from a 16-byte boundary
  static constexpr bool LEAN = DH > 128;       // q fragments in shared memory, int8 V converted late
};

struct DecodeArgs {
  const __nv_bfloat16* q;
  const void* k;                 // bf16 or int8 code stack
  const void* v;
  const __nv_bfloat16* ks;       // int8 cache: scale stacks [L, B, Hkv, S]
  const __nv_bfloat16* vs;
  const int* pos;
  const int* layer;
  const int* row_start;
  float* part_m;
  float* part_l;
  float* part_acc;
  int* tickets;
  __nv_bfloat16* out;
  float* m_out;
  float* l_out;
  int B, S, Hq, Hkv, kv_width, n_split, window;
  float softcap, scale;
};

// Shared memory of one CTA, in bytes.
template <int DH, Cache C>
struct Smem {
  using Geo = Geom<DH>;
  static constexpr int ESIZE = C == Cache::kBf16 ? 2 : 1;  // bytes per cached element
  static constexpr int LD = DH * ESIZE + 16;   // slot row pitch: ldmatrix rows hit distinct banks
  static constexpr int TILE = Geo::CHUNK * LD;  // one K or V chunk
  static constexpr int SCALES = C == Cache::kBf16 ? 0 : Geo::SCALE_RUN * 2;  // one scale run
  static constexpr int STAGE = 2 * TILE + 2 * SCALES;
  static constexpr int RING = kStages * STAGE;
  static constexpr int LDO = DH + 4;           // fp32 pitch of the warps' merge buffer
  static constexpr int O_BYTES = Geo::WARPS * 16 * LDO * 4;
  static constexpr int STAT_BYTES = 2 * Geo::WARPS * 16 * 4;  // per-warp m and l of 16 rows
  // After the loop the ring holds the warps' O and (m, l), the split weights
  // and (M, l) of each head, then the split lanes' float4 sums.
  __host__ __device__ static int sum_offset(int n_split) {
    return (O_BYTES + STAT_BYTES + (kMaxGroup * n_split + 2 * kMaxGroup) * 4 + 15) & ~15;
  }
  __host__ __device__ static int bytes(int n_split) {
    const int merge = sum_offset(n_split) + Geo::THREADS * kMaxGroup * 16;
    return merge > RING ? merge : RING;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !valid (nothing is read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a.b, m16n8k16, bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a.b, m16n8k32, int8 in, int32 accumulate (exact).
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Four int8 codes (byte i of w) -> the bf16 pairs (c0, c1) and (c2, c3),
// exactly: the float 2^23 + (c ^ 0x80) holds the biased code in its low
// byte, subtracting 2^23 + 128 leaves c, and since |c| <= 128 needs at most
// 8 significant bits, the float's high half is its bf16.
__device__ __forceinline__ void codes_to_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// The codes of two slot rows x and y (4 dh values each) -> bf16 pairs
// (x_i, y_i), i = 0..3: the B operand of P.V pairs neighbouring slots.
__device__ __forceinline__ void pair_codes(uint32_t x, uint32_t y, uint32_t (&p)[4]) {
  codes_to_bf16(__byte_perm(x, y, 0x5140), p[0], p[1]);
  codes_to_bf16(__byte_perm(x, y, 0x7362), p[2], p[3]);
}

// Symmetric int8 code of x at scale s, as ops/quant.quantize_rows_sym.
__device__ __forceinline__ uint32_t q_code(float x, float s) {
  return static_cast<uint32_t>(static_cast<int>(fminf(fmaxf(rintf(x / s), -127.f), 127.f))) &
         0xFFu;
}

// N 32-bit words from shared memory (N = 1, 2 or 4: one vector load).
template <int N>
__device__ __forceinline__ void load_words(uint32_t (&w)[N], const unsigned char* p) {
  static_assert(N == 1 || N == 2 || N == 4, "one vector load holds 1, 2 or 4 words");
  if constexpr (N == 4) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    w[0] = x.x, w[1] = x.y, w[2] = x.z, w[3] = x.w;
  } else if constexpr (N == 2) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    w[0] = x.x, w[1] = x.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

// One CTA per (split, kv head, batch row). The split covers slots
// [split * kv_width / n_split, (split + 1) * kv_width / n_split); the CTA
// streams the valid part of it (inside [row_start, pos] and the window) in
// chunks of 16 slots a warp through the ring; each warp scores its 16 slots
// of a chunk and keeps its own online softmax and O fragment in registers.
// The warps merge through shared memory at the end. With one split the CTA
// writes the output; otherwise it writes an fp32 partial and takes a ticket,
// and the last CTA of the (row, kv head) merges the partials and resets the
// ticket.
template <int DH, Cache C>
__device__ __forceinline__ void decode_body(const DecodeArgs& a) {
  using L = Smem<DH, C>;
  using Geo = Geom<DH>;
  constexpr bool kQuant = C != Cache::kBf16;
  constexpr int kWarps = Geo::WARPS, kThreads = Geo::THREADS, kChunk = Geo::CHUNK;
  constexpr int kScaleRun = Geo::SCALE_RUN;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;

  const int split = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = a.Hq / a.Hkv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g8 = lane >> 2;  // fragment rows g8 and g8 + 8: query heads of the group
  const int quad = lane & 3;

  // The device scalars first (nothing below waits on them until the split
  // bounds), then q of the group as A fragments, loaded once (rows past G
  // are zero).
  const int pos = *a.pos;
  const int layer = *a.layer;
  int lo = a.row_start[b];
  const __nv_bfloat16* qg =
      a.q + (static_cast<int64_t>(b) * a.Hq + static_cast<int64_t>(hk) * G) * DH;
  const __nv_bfloat16* q0 = qg + g8 * DH;
  const __nv_bfloat16* q1 = q0 + 8 * DH;
  const bool row0 = g8 < G, row1 = g8 + 8 < G;
  constexpr int kQSteps = C == Cache::kW8A8 ? DH / 32 : DH / 16;
  uint32_t qa[kQSteps][4];
  float qs0 = 1.f, qs1 = 1.f;  // W8A8: the q scales of rows g8, g8 + 8
  if constexpr (C == Cache::kBf16) {
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const int c = 16 * kk + 2 * quad;
      qa[kk][0] = row0 ? load_pair(q0 + c) : 0u;
      qa[kk][1] = row1 ? load_pair(q1 + c) : 0u;
      qa[kk][2] = row0 ? load_pair(q0 + c + 8) : 0u;
      qa[kk][3] = row1 ? load_pair(q1 + c + 8) : 0u;
    }
  } else if constexpr (C == Cache::kInt8) {
    // The K codes reach a thread as dh 4 quad .. 4 quad + 3 of each 16
    // (below), where the bf16 B layout wants k 2 quad, 2 quad + 1 and
    // 2 quad + 8, 2 quad + 9: q's columns are permuted to the same order.
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const int c = 16 * kk + 4 * quad;
      const uint2 x0 = row0 ? *reinterpret_cast<const uint2*>(q0 + c) : make_uint2(0u, 0u);
      const uint2 x1 = row1 ? *reinterpret_cast<const uint2*>(q1 + c) : make_uint2(0u, 0u);
      qa[kk][0] = x0.x;
      qa[kk][1] = x1.x;
      qa[kk][2] = x0.y;
      qa[kk][3] = x1.y;
    }
  } else {
    // One warp per query head: lane i quantizes dh 4i .. 4i + 3 of each
    // 128-wide stride of the head (one stride up to dh 128, two at dh 256;
    // the head's amax over all of them is a warp reduction), rows past G
    // are zero codes, and the codes go through shared memory into the
    // m16n8k32 A layout: a thread holds dh 4 quad .. + 3 and 16 + 4 quad ..
    // + 3 of each 32 for rows g8 and g8 + 8.
    constexpr int kLdq = DH + 16;  // bytes per head: the fragment reads hit distinct banks
    constexpr int kStrides = DH > 128 ? DH / 128 : 1;
    __shared__ __align__(16) unsigned char sq8[kMaxGroup * kLdq];
    __shared__ float sqs[kMaxGroup];
    for (int g = warp; g < kMaxGroup; g += kWarps) {
      float x[kStrides][4];
      float amax = 0.f;
#pragma unroll
      for (int r = 0; r < kStrides; ++r) {
        const int d = 128 * r + 4 * lane;
        x[r][0] = x[r][1] = x[r][2] = x[r][3] = 0.f;
        if (g < G && d < DH) {
          const uint2 raw = *reinterpret_cast<const uint2*>(qg + g * DH + d);
          const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
          const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
          x[r][0] = lo.x, x[r][1] = lo.y, x[r][2] = hi.x, x[r][3] = hi.y;
        }
        amax = fmaxf(amax, fmaxf(fmaxf(fabsf(x[r][0]), fabsf(x[r][1])),
                                 fmaxf(fabsf(x[r][2]), fabsf(x[r][3]))));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
      }
      const float qs = fmaxf(amax * (1.f / 127.f), 1e-30f);
#pragma unroll
      for (int r = 0; r < kStrides; ++r) {
        const int d = 128 * r + 4 * lane;
        if (d < DH) {
          uint32_t codes = 0u;
          if (g < G) {
            codes = q_code(x[r][0], qs) | q_code(x[r][1], qs) << 8 |
                    q_code(x[r][2], qs) << 16 | q_code(x[r][3], qs) << 24;
          }
          *reinterpret_cast<uint32_t*>(sq8 + g * kLdq + d) = codes;
        }
      }
      if (lane == 0) sqs[g] = qs;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < DH / 32; ++kk) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = 32 * kk + 16 * h + 4 * quad;
        qa[kk][2 * h] = *reinterpret_cast<const uint32_t*>(sq8 + g8 * kLdq + c);
        qa[kk][2 * h + 1] = *reinterpret_cast<const uint32_t*>(sq8 + (g8 + 8) * kLdq + c);
      }
    }
    qs0 = sqs[g8];
    qs1 = sqs[g8 + 8];
  }
  // dh 256: every warp holds the same fragments, so warp 0 parks them in
  // shared memory (lane-major 16-byte rows: conflict-free reads) and the
  // scores read each k-step's as they go; the loop's first barrier orders
  // the stores before any read.
  __shared__ __align__(16) uint4 sqa[Geo::LEAN ? kQSteps * 32 : 1];
  if constexpr (Geo::LEAN) {
    if (warp == 0) {
#pragma unroll
      for (int kk = 0; kk < kQSteps; ++kk) {
        sqa[kk * 32 + lane] = make_uint4(qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3]);
      }
    }
  }
  // q's A fragment of k-step kk.
  auto q_frag = [&](int kk, uint32_t (&f)[4]) {
    if constexpr (Geo::LEAN) {
      const uint4 x = sqa[kk * 32 + lane];
      f[0] = x.x, f[1] = x.y, f[2] = x.z, f[3] = x.w;
    } else {
      f[0] = qa[kk][0], f[1] = qa[kk][1], f[2] = qa[kk][2], f[3] = qa[kk][3];
    }
  };

  if (a.window > 0) lo = max(lo, pos - a.window + 1);
  const int first =
      max(lo, static_cast<int>(static_cast<int64_t>(split) * a.kv_width / a.n_split));
  const int last =
      min(pos, static_cast<int>(static_cast<int64_t>(split + 1) * a.kv_width / a.n_split) - 1);
  const int n_chunks = first <= last ? (last - first) / kChunk + 1 : 0;

  // Offsets are int64: the long-context cache holds 131,072 slots a row.
  const int64_t kv_pitch = static_cast<int64_t>(a.Hkv) * DH * L::ESIZE;  // bytes per slot
  const int64_t layer_off = ((static_cast<int64_t>(layer) * a.B + b) * a.S) * kv_pitch +
                            static_cast<int64_t>(hk) * DH * L::ESIZE;
  const unsigned char* kb = static_cast<const unsigned char*>(a.k) + layer_off;
  const unsigned char* vb = static_cast<const unsigned char*>(a.v) + layer_off;
  // int8: this (row, kv head)'s scale rows, seq-minor [L, B, Hkv, S].
  const int64_t srow = ((static_cast<int64_t>(layer) * a.B + b) * a.Hkv + hk) * a.S;

  constexpr int kSegs = DH * L::ESIZE / 16;  // 16-byte segments per slot row
  constexpr int kScaleCopies = kScaleRun / 8;
  auto issue = [&](int c) {
    unsigned char* sk = smem + (c % kStages) * L::STAGE;
    unsigned char* sv = sk + L::TILE;
    const int c0 = first + c * kChunk;
#pragma unroll
    for (int it = 0; it < kChunk * kSegs / kThreads; ++it) {
      const int i = tid + it * kThreads;
      const int r = i / kSegs;
      const int d = (i % kSegs) * 16;
      const bool ok = c0 + r <= last;
      const int64_t off = static_cast<int64_t>(ok ? c0 + r : first) * kv_pitch + d;
      cp_async16(sk + r * L::LD + d, kb + off, ok);
      cp_async16(sv + r * L::LD + d, vb + off, ok);
    }
    if constexpr (kQuant) {
      // The chunk's scales from the 16-byte boundary at or before slot c0
      // (the scale stacks start on one): 8 slots a copy; a copy that starts
      // past `last` is zero-filled.
      if (tid < 2 * kScaleCopies) {
        const bool is_v = tid >= kScaleCopies;
        const int j = is_v ? tid - kScaleCopies : tid;
        const int64_t s0 = srow + c0 - ((srow + c0) & 7) + 8 * j;
        const bool ok = s0 - srow <= last;
        const __nv_bfloat16* src = (is_v ? a.vs : a.ks) + (ok ? s0 : s0 - 8 * j);
        cp_async16(sv + L::TILE + (is_v ? L::SCALES : 0) + 16 * j, src, ok);
      }
    }
  };
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < n_chunks) issue(c);
    cp_async_commit();
  }

  float acc[DH / 8][4];  // this warp's O: fragment rows g8, g8 + 8
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // running max (natural units)
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the denominator

  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk c landed for every thread; chunk c - 1's stage is free
    if (c + kStages - 1 < n_chunks) issue(c + kStages - 1);
    cp_async_commit();
    const unsigned char* sk = smem + (c % kStages) * L::STAGE;
    const unsigned char* sv = sk + L::TILE;
    const int row = 16 * warp;  // this warp's 16 slots of the chunk
    const int c0 = first + c * kChunk;
    // int8: the chunk's scales; slot c0 + r sits at index lead + r.
    const int lead = kQuant ? static_cast<int>((srow + c0) & 7) : 0;
    const __nv_bfloat16* sks = reinterpret_cast<const __nv_bfloat16*>(sv + L::TILE) + lead;
    const __nv_bfloat16* svs = sks + kScaleRun;

    // int8 V as the B operand of P.V, converted now (it waits on nothing
    // the scores compute; at dh 256 inside P.V instead, a word at a time).
    // n8-tile n's column g8 is dh g8 * DH/8 + n, so a thread's B columns are
    // the contiguous DH/8 codes at g8 * DH/8 of its four slot rows (row +
    // 2 quad, + 1, + 8, + 9: the k of the B fragment), paired across
    // neighbouring slots.
    constexpr bool kEarlyV = kQuant && !Geo::LEAN;
    [[maybe_unused]] uint32_t vb[kEarlyV ? DH / 8 : 1][2];
    if constexpr (kEarlyV) {
      constexpr int kW = DH / 32;  // 32-bit words of a thread's run
      uint32_t vw[4][kW];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        load_words(vw[i], sv + (row + 2 * quad + (i & 1) + 8 * (i >> 1)) * L::LD + g8 * (DH / 8));
      }
#pragma unroll
      for (int w = 0; w < kW; ++w) {
        uint32_t b0[4], b1[4];
        pair_codes(vw[0][w], vw[1][w], b0);
        pair_codes(vw[2][w], vw[3][w], b1);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          vb[4 * w + t][0] = b0[t];
          vb[4 * w + t][1] = b1[t];
        }
      }
    }

    // S = q K^T over the warp's slots: two n8 tiles. ldmatrix.x4 reads the
    // 32 bytes kk of rows row .. row + 15 as four 8x8 b16 matrices: (slots
    // 0-7, bytes 0-15), (0-7, 16-31), (8-15, 0-15), (8-15, 16-31).
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    const unsigned char* krow =
        sk + (row + (lane >> 4) * 8 + (lane & 7)) * L::LD + ((lane >> 3) & 1) * 16;
    if constexpr (C == Cache::kW8A8) {
      int si[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
#pragma unroll
      for (int kk = 0; kk < DH / 32; ++kk) {
        uint32_t kf[4], qf[4];
        ldmatrix_x4(kf, krow + 32 * kk);
        q_frag(kk, qf);
        mma_s8(si[0], qf, kf[0], kf[1]);
        mma_s8(si[1], qf, kf[2], kf[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = static_cast<float>(si[j][e]) * (e < 2 ? qs0 : qs1);
      }
    } else {
      // int8: the odd 16-wide dh segments accumulate apart, so the two
      // dependent product chains of a tile are half as long.
      [[maybe_unused]] float s_odd[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < DH * L::ESIZE / 32; ++kk) {
        uint32_t kf[4];
        ldmatrix_x4(kf, krow + 32 * kk);
        if constexpr (C == Cache::kBf16) {
          uint32_t qf[4];
          q_frag(kk, qf);
          mma_bf16(s[0], qf, kf[0], kf[1]);
          mma_bf16(s[1], qf, kf[2], kf[3]);
        } else {
          uint32_t kb16[4][2], qe[4], qo[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) codes_to_bf16(kf[i], kb16[i][0], kb16[i][1]);
          q_frag(2 * kk, qe);
          q_frag(2 * kk + 1, qo);
          mma_bf16(s[0], qe, kb16[0][0], kb16[0][1]);
          mma_bf16(s_odd[0], qo, kb16[1][0], kb16[1][1]);
          mma_bf16(s[1], qe, kb16[2][0], kb16[2][1]);
          mma_bf16(s_odd[1], qo, kb16[3][0], kb16[3][1]);
        }
      }
      if constexpr (C == Cache::kInt8) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] += s_odd[j][e];
        }
      }
    }

    // K scale, scale, softcap, mask (a select: NaN scales of invalid slots
    // never count); online softmax of rows g8 and g8 + 8.
    bool valid[2][2];
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row + 8 * j + 2 * quad + (e & 1);
        float x = s[j][e];
        if constexpr (kQuant) x = x * __bfloat162float(sks[r]);
        x = x * a.scale;
        if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
        const bool ok = c0 + r <= last;
        if (e < 2) valid[j][e] = ok;
        s[j][e] = ok ? x : kNegInf;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f((m0 - mn0) * kLog2e), alpha1 = exp2f((m1 - mn1) * kLog2e);
    m0 = mn0;
    m1 = mn1;
    float p[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      p[j][0] = valid[j][0] ? exp2f((s[j][0] - mn0) * kLog2e) : 0.f;
      p[j][1] = valid[j][1] ? exp2f((s[j][1] - mn0) * kLog2e) : 0.f;
      p[j][2] = valid[j][0] ? exp2f((s[j][2] - mn1) * kLog2e) : 0.f;
      p[j][3] = valid[j][1] ? exp2f((s[j][3] - mn1) * kLog2e) : 0.f;
    }
    l0 = l0 * alpha0 + (p[0][0] + p[0][1] + p[1][0] + p[1][1]);
    l1 = l1 * alpha1 + (p[0][2] + p[0][3] + p[1][2] + p[1][3]);
    if constexpr (kQuant) {
      // The V scale folds into p after l, through a select.
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = row + 8 * j + 2 * quad + (e & 1);
          p[j][e] = valid[j][e & 1] ? p[j][e] * __bfloat162float(svs[r]) : 0.f;
        }
      }
    }
    const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                            pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};

    // O = alpha O + P V over the warp's 16 slots.
    if constexpr (C == Cache::kBf16) {
#pragma unroll
      for (int nn = 0; nn < DH / 16; ++nn) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, sv + (row + ((lane >> 3) & 1) * 8 + (lane & 7)) * L::LD + nn * 32 +
                                  (lane >> 4) * 16);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* o = acc[2 * nn + h];
          o[0] *= alpha0;
          o[1] *= alpha0;
          o[2] *= alpha1;
          o[3] *= alpha1;
          mma_bf16(acc[2 * nn + h], pa, vf[2 * h], vf[2 * h + 1]);
        }
      }
    } else {
#pragma unroll
      for (int w = 0; w < DH / 32; ++w) {
        // The B fragments of n8-tiles 4 w .. 4 w + 3: word w of the thread's
        // four slot rows.
        uint32_t b0[4], b1[4];
        if constexpr (kEarlyV) {
#pragma unroll
          for (int t = 0; t < 4; ++t) b0[t] = vb[4 * w + t][0], b1[t] = vb[4 * w + t][1];
        } else {
          uint32_t x[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            x[i] = *reinterpret_cast<const uint32_t*>(
                sv + (row + 2 * quad + (i & 1) + 8 * (i >> 1)) * L::LD + g8 * (DH / 8) + 4 * w);
          }
          pair_codes(x[0], x[1], b0);
          pair_codes(x[2], x[3], b1);
        }
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          float* o = acc[4 * w + t];
          o[0] *= alpha0;
          o[1] *= alpha0;
          o[2] *= alpha1;
          o[3] *= alpha1;
          mma_bf16(acc[4 * w + t], pa, b0[t], b1[t]);
        }
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  __syncthreads();  // the ring is free: reuse it for the merges

  // Merge the warps: per row, M = max m_w, O = sum_w e^(m_w - M) O_w.
  float* sO = reinterpret_cast<float*>(smem);                    // [warp][16][LDO]
  float* sM = reinterpret_cast<float*>(smem + L::O_BYTES);       // [warp][16]
  float* sL = sM + kWarps * 16;                                  // [warp][16]
  if (quad == 0) {
    sM[warp * 16 + g8] = m0;
    sM[warp * 16 + g8 + 8] = m1;
    sL[warp * 16 + g8] = l0;
    sL[warp * 16 + g8 + 8] = l1;
  }
  __syncthreads();
  float M0 = kNegInf, M1 = kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    M0 = fmaxf(M0, sM[w * 16 + g8]);
    M1 = fmaxf(M1, sM[w * 16 + g8 + 8]);
  }
  const float f0 = exp2f((m0 - M0) * kLog2e), f1 = exp2f((m1 - M1) * kLog2e);
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    // The fragment's columns 2 quad, 2 quad + 1 of n8-tile n, as dh.
    const int col = kQuant ? 2 * quad * (DH / 8) + n : 8 * n + 2 * quad;
    const int next = kQuant ? DH / 8 : 1;
    float* o0 = sO + (warp * 16 + g8) * L::LDO + col;
    float* o1 = o0 + 8 * L::LDO;
    o0[0] = acc[n][0] * f0;
    o0[next] = acc[n][1] * f0;
    o1[0] = acc[n][2] * f1;
    o1[next] = acc[n][3] * f1;
  }
  __syncthreads();

  const int64_t head0 = static_cast<int64_t>(b) * a.Hq + static_cast<int64_t>(hk) * G;
  for (int i = tid; i < G * DH; i += kThreads) {
    const int g = i / DH, d = i % DH;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sM[w * 16 + g]);
    float l = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      l += sL[w * 16 + g] * exp2f((sM[w * 16 + g] - M) * kLog2e);
      o += sO[(w * 16 + g) * L::LDO + d];
    }
    if (a.n_split == 1) {
      a.out[(head0 + g) * DH + d] = __float2bfloat16(l == 0.f ? 0.f : o / l);
      if (a.m_out != nullptr && d == 0) {
        a.m_out[head0 + g] = M;
        a.l_out[head0 + g] = l;
      }
    } else {
      const int64_t pi = (head0 + g) * a.n_split + split;
      a.part_acc[pi * DH + d] = o;
      if (d == 0) {
        a.part_m[pi] = M;
        a.part_l[pi] = l;
      }
    }
  }
  if (a.n_split == 1) return;

  // Ticket: the last CTA of this (row, kv head) to finish merges the splits.
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&a.tickets[b * a.Hkv + hk], 1) == a.n_split - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int n_split = a.n_split;
  float* sW = sL + kWarps * 16;             // [G][n_split]: e^(m_s - M)
  float* sStat = sW + kMaxGroup * n_split;  // [G][2]: M, l
  for (int g = warp; g < G; g += kWarps) {
    const int64_t pb = (head0 + g) * n_split;
    float M = kNegInf;
    for (int sp = lane; sp < n_split; sp += 32) M = fmaxf(M, __ldcg(a.part_m + pb + sp));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    float l = 0.f;
    for (int sp = lane; sp < n_split; sp += 32) {
      const float pl = __ldcg(a.part_l + pb + sp);
      const float w = pl == 0.f ? 0.f : exp2f((__ldcg(a.part_m + pb + sp) - M) * kLog2e);
      sW[g * n_split + sp] = w;
      l += pl * w;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) {
      sStat[2 * g] = M;
      sStat[2 * g + 1] = l;
    }
  }
  __syncthreads();
  // O = sum_s w_s acc_s: each thread owns 4 columns of one head and a
  // share of the splits (kThreads / (DH / 4) split lanes), so its loads are
  // independent 16-byte loads; the lanes then add up through shared memory.
  constexpr int kCols = DH / 4;             // float4 columns of a row
  constexpr int kLanes = kThreads / kCols;  // split lanes per column
  float4* sSum = reinterpret_cast<float4*>(smem + L::sum_offset(n_split));  // [kLanes][G][kCols]
  const int col = tid % kCols, sl = tid / kCols;
  for (int g = 0; g < G; ++g) {
    const float4* pa = reinterpret_cast<const float4*>(a.part_acc + (head0 + g) * n_split * DH);
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int sp = sl; sp < n_split; sp += kLanes) {
      const float w = sW[g * n_split + sp];
      const float4 x = __ldcg(pa + sp * kCols + col);
      o.x += w * x.x;
      o.y += w * x.y;
      o.z += w * x.z;
      o.w += w * x.w;
    }
    sSum[(sl * G + g) * kCols + col] = o;
  }
  __syncthreads();
  for (int i = tid; i < G * kCols; i += kThreads) {
    const int g = i / kCols, c = i % kCols;
    float4 o = sSum[g * kCols + c];
    for (int j = 1; j < kLanes; ++j) {
      const float4 x = sSum[(j * G + g) * kCols + c];
      o.x += x.x;
      o.y += x.y;
      o.z += x.z;
      o.w += x.w;
    }
    const float l = sStat[2 * g + 1];
    const float inv = l == 0.f ? 0.f : 1.f / l;
    __nv_bfloat16* dst = a.out + (head0 + g) * DH + 4 * c;
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(o.x * inv, o.y * inv);
    *reinterpret_cast<__nv_bfloat162*>(dst + 2) = __floats2bfloat162_rn(o.z * inv, o.w * inv);
    if (a.m_out != nullptr && c == 0) {
      a.m_out[head0 + g] = sStat[2 * g];
      a.l_out[head0 + g] = l;
    }
  }
  if (tid == 0) a.tickets[b * a.Hkv + hk] = 0;  // ready for the next launch (and graph replay)
}

template <int DH>
__global__ void __launch_bounds__(Geom<DH>::THREADS)
decode_bf16_kernel(const __grid_constant__ DecodeArgs a) {
  decode_body<DH, Cache::kBf16>(a);
}

template <int DH, bool W8A8>
__global__ void __launch_bounds__(Geom<DH>::THREADS)
decode_q8_kernel(const __grid_constant__ DecodeArgs a) {
  decode_body<DH, W8A8 ? Cache::kW8A8 : Cache::kInt8>(a);
}

template <int DH, Cache C>
cudaError_t launch(const DecodeArgs& a, cudaStream_t stream) {
  void (*kernel)(const DecodeArgs);
  if constexpr (C == Cache::kBf16) {
    kernel = decode_bf16_kernel<DH>;
  } else {
    kernel = decode_q8_kernel<DH, C == Cache::kW8A8>;
  }
  // The shared-memory opt-in, once per device, at the most any split count
  // needs: the attribute call costs microseconds of host time, and a size
  // set per call could be lowered by another thread between its set and
  // its launch.
  static std::atomic<bool> opted[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !opted[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Smem<DH, C>::bytes(kMaxSplit));
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) opted[dev].store(true, std::memory_order_release);
  }
  kernel<<<dim3(a.n_split, a.Hkv, a.B), Geom<DH>::THREADS, Smem<DH, C>::bytes(a.n_split),
           stream>>>(a);
  return cudaGetLastError();
}

template <Cache C>
int dispatch(const DecodeArgs& a, int dh, void* stream) {
  const bool scratch = a.part_m && a.part_l && a.part_acc && a.tickets;
  if (a.Hkv <= 0 || a.Hq % a.Hkv != 0 || a.Hq / a.Hkv > kMaxGroup || a.n_split < 1 ||
      a.n_split > kMaxSplit || a.n_split > a.kv_width || (a.n_split > 1 && !scratch) ||
      (C != Cache::kBf16 && (a.ks == nullptr || a.vs == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32:
      return launch<32, C>(a, st);
    case 64:
      return launch<64, C>(a, st);
    case 128:
      return launch<128, C>(a, st);
    case 256:
      return launch<256, C>(a, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

DecodeArgs args_of(const void* q, const void* k, const void* v, const void* ks, const void* vs,
                   const void* pos, const void* layer, const void* row_start, void* part_m,
                   void* part_l, void* part_acc, void* tickets, void* out, void* m_out,
                   void* l_out, int B, int S, int Hq, int Hkv, int kv_width, int n_split,
                   int window, float softcap, float scale) {
  return DecodeArgs{static_cast<const __nv_bfloat16*>(q), k, v,
                    static_cast<const __nv_bfloat16*>(ks), static_cast<const __nv_bfloat16*>(vs),
                    static_cast<const int*>(pos), static_cast<const int*>(layer),
                    static_cast<const int*>(row_start), static_cast<float*>(part_m),
                    static_cast<float*>(part_l), static_cast<float*>(part_acc),
                    static_cast<int*>(tickets), static_cast<__nv_bfloat16*>(out),
                    static_cast<float*>(m_out), static_cast<float*>(l_out), B, S, Hq, Hkv,
                    kv_width, n_split, window, softcap, scale};
}

}  // namespace

extern "C" {

// q [B, 1, Hq, dh]; k/v [L, B, S, Hkv, dh]; out [B, 1, Hq, dh]: bf16,
// contiguous, 16-byte aligned. pos and layer are int32 device scalars,
// row_start an int32 device vector [B]. n_split (1 to 512, at most
// kv_width) is the host's split plan (ops/kernels/decode_attention.
// split_plan); with n_split > 1, part_m / part_l are fp32 scratch
// [B, Hq, n_split], part_acc fp32 scratch [B, Hq, n_split, dh] and tickets
// an int32 buffer of at least B * Hkv zeros that the kernel leaves zero (any
// of them may be NULL when n_split is 1). m_out / l_out are fp32 [B, Hq]
// (the softmax state), or both NULL. window <= 0 disables the sliding
// window, softcap <= 0 the softcap. Returns the cudaError_t of the launch
// (0 on success).
int llmc_decode_attention_bf16(const void* q, const void* k, const void* v, const void* pos,
                               const void* layer, const void* row_start, void* part_m,
                               void* part_l, void* part_acc, void* tickets, void* out,
                               void* m_out, void* l_out, int B, int S, int Hq, int Hkv, int dh,
                               int kv_width, int n_split, int window, float softcap, float scale,
                               void* stream) {
  return dispatch<Cache::kBf16>(args_of(q, k, v, nullptr, nullptr, pos, layer, row_start,
                                        part_m, part_l, part_acc, tickets, out, m_out, l_out, B,
                                        S, Hq, Hkv, kv_width, n_split, window, softcap, scale),
                                dh, stream);
}

// The int8 cache: k/v codes [L, B, S, Hkv, dh] int8, ks/vs scales
// [L, B, Hkv, S] bf16 (seq-minor, 16-byte aligned; S may be any length);
// everything else as above.
int llmc_decode_attention_int8(const void* q, const void* k, const void* v, const void* ks,
                               const void* vs, const void* pos, const void* layer,
                               const void* row_start, void* part_m, void* part_l,
                               void* part_acc, void* tickets, void* out, void* m_out,
                               void* l_out, int B, int S, int Hq, int Hkv, int dh, int kv_width,
                               int n_split, int window, float softcap, float scale,
                               void* stream) {
  return dispatch<Cache::kInt8>(args_of(q, k, v, ks, vs, pos, layer, row_start, part_m, part_l,
                                        part_acc, tickets, out, m_out, l_out, B, S, Hq, Hkv,
                                        kv_width, n_split, window, softcap, scale),
                                dh, stream);
}

// The int8 cache with int8 x int8 scores (q quantized per head in the kernel).
int llmc_decode_attention_int8_w8a8(const void* q, const void* k, const void* v,
                                    const void* ks, const void* vs, const void* pos,
                                    const void* layer, const void* row_start, void* part_m,
                                    void* part_l, void* part_acc, void* tickets, void* out,
                                    void* m_out, void* l_out, int B, int S, int Hq, int Hkv,
                                    int dh, int kv_width, int n_split, int window,
                                    float softcap, float scale, void* stream) {
  return dispatch<Cache::kW8A8>(args_of(q, k, v, ks, vs, pos, layer, row_start, part_m, part_l,
                                        part_acc, tickets, out, m_out, l_out, B, S, Hq, Hkv,
                                        kv_width, n_split, window, softcap, scale),
                                dh, stream);
}

}  // extern "C"
