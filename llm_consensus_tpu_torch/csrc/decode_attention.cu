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
// Three variants:
//   * bf16 cache k/v [L, B, S, Hkv, dh] (decode_bf16_kernel, one launch per
//     call: the design below);
//   * int8 cache (decode_partial_q8_kernel<DH, false>): codes
//     [L, B, S, Hkv, dh] int8 and per-slot scales [L, B, Hkv, S] bf16
//     (seq-minor). The TPU kernel's _qstruct_block / per-head form: scores
//     = q . k_codes in fp32, times the slot's K scale, times `scale`, then
//     softcap and mask; m and l come from the unscaled p; then p is
//     multiplied by the slot's V scale (zero outside [lo, hi]: a select, so
//     NaN scales past the frontier never reach the output) and P.V runs on
//     the codes. No dequantized K/V exists;
//   * int8 cache with int8 x int8 scores (decode_partial_q8_kernel<DH,
//     true>, the TPU kernel's _qstruct_w8a8_block): each CTA quantizes its
//     query heads per head over dh (scale max(amax * (1/127), 1e-30), codes
//     rint(q / scale) clamped to 127, as ops/quant.quantize_rows_sym), the
//     score is an exact int32 dot (__dp4a) times q scale times K scale times
//     `scale`; the rest as the int8 variant (P.V in bf16).
//
// What bounds it on this card: bytes. Each step reads the valid K/V rows of
// one layer once (2 * 2 * n_valid * Hkv * dh bytes in bf16; the int8 cache
// half that plus 4 * n_valid * Hkv bytes of scales) and does ~4 operations
// per element read, far below the ~295 FLOPs/byte ridge. At batch 1 the TPU
// kernel's one-program-per-(row, kv head) form would occupy 8 of 132 SMs,
// so every variant splits the kv span (flash-decoding). At the main path's
// widths (a few hundred slots) the bytes take well under a microsecond, so
// latency bounds the kernel: launches, dependent loads, barriers.
//
// The bf16 kernel's design answers both:
//   * one launch per call. Each CTA (split, kv head, row) writes an fp32
//     partial (m, l, acc) and takes a ticket (__threadfence, then atomicAdd
//     on an int32 per (row, kv head)); the last CTA to arrive merges the
//     partials exactly (o = sum_i w_i acc_i / sum_i w_i l_i, w_i =
//     exp(m_i - m)) and resets its ticket to 0, so the next launch and a
//     CUDA-graph replay find it zero. With one split the CTA writes the
//     output directly;
//   * a split plan made on the host from the shape (ops/kernels/
//     decode_attention.split_plan): at most one CTA per SM in all, so every
//     CTA runs in the first wave, and no split shorter than 256 slots (one
//     merge round trip costs more than a shorter split saves), so the split
//     count follows the width and the batch instead of one CTA per 64 slots
//     (1,024 CTAs at width 8,192 before). Each CTA streams its split's valid
//     slots in 128-slot chunks through a 3-stage cp.async ring (zero-fill for
//     the rows outside [row_start, pos] and the window: they are never read,
//     and NaN there cannot reach the output), so chunk loads overlap scoring.
//     With one CTA to an SM, eight warps (16 slots each per chunk) hide the
//     latency of each warp's dependent products;
//   * tensor-core arithmetic on registers: the kv head's G query heads are
//     the 16 rows of an mma.sync m16n8k16 A operand loaded once into
//     registers (zero past G); each warp scores 16 slots of a chunk
//     (ldmatrix of K), keeps its online softmax and its O fragment in
//     registers across chunks, and feeds P (bf16, as the TPU kernel casts p)
//     back as the A operand of P.V (ldmatrix.trans of V). The warps merge
//     once, through shared memory, at the end. mma.sync rather than FMA:
//     with q in registers the scores need no shared-memory traffic for q,
//     one code path serves every group from 1 to 16, and a 16-head group
//     costs no more than a 1-head one.
//
// The int8 variants keep the first design: one CTA per (64-slot chunk, kv
// head, row) stages its chunk (codes, and the chunk's two scale rows) in
// shared memory with independent 16-byte loads, scores it, writes a partial,
// and decode_merge_kernel merges the partials in a second launch.
//
// return_state (every variant; the TPU kernel's return_state=True, for the
// shared-prefix decode path's two-source merge): whichever code merges the
// splits holds each (row, query head)'s global softmax state, so when
// m_out/l_out are non-null it writes it beside the output, fp32 [B, Hq], in
// the same launch: m = the max of the scaled, softcapped, masked scores;
// l = the sum of exp(s - m) over valid slots, taken before the int8 V scale
// folds into p (chunk_softmax sums first, then scales). A row with no valid
// slot writes m = -1e30 and l = 0. The output is the bf16-rounded
// normalized attention, as the TPU kernel's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChunk = 64;    // kv slots per chunk (per CTA for the int8 kernels)
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 16; // query heads per kv head
constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value

__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }

// A chunk with nothing valid: m = -inf-ish, l = 0 drops it in the merge.
template <int DH>
__device__ void write_empty_partial(float* part_m, float* part_l, float* part_acc,
                                    int64_t part_base, int G, int n_split) {
  const int tid = threadIdx.x;
  for (int g = tid; g < G; g += kThreads) {
    part_m[part_base + (int64_t)g * n_split] = kNegInf;
    part_l[part_base + (int64_t)g * n_split] = 0.f;
  }
  for (int i = tid; i < G * DH; i += kThreads) {
    const int g = i / DH, d = i % DH;
    part_acc[(part_base + (int64_t)g * n_split) * DH + d] = 0.f;
  }
}

// Softmax within the chunk, one warp per query head, over the masked
// scores sp[g][r]: m and l = sum(p) of the unscaled p in fp32 go to the
// partials; p, times vscale[r] when given (int8: the slot's V scale, 0
// outside [lo, hi]), is stored back rounded to bf16, as the TPU kernel
// casts p before P.V.
__device__ void chunk_softmax(float (*sp)[kChunk], const float* vscale, int G, int c0,
                              int lo, int hi, float* part_m, float* part_l,
                              int64_t part_base, int n_split) {
  constexpr int kPerLane = kChunk / 32;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int g = warp; g < G; g += kWarps) {
    float mx = kNegInf;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) mx = fmaxf(mx, sp[g][lane + 32 * i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int r = lane + 32 * i;
      float p = (c0 + r <= hi && c0 + r >= lo) ? expf(sp[g][r] - mx) : 0.f;
      sum += p;
      if (vscale != nullptr) p *= vscale[r];
      sp[g][r] = __bfloat162float(__float2bfloat16(p));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      part_m[part_base + (int64_t)g * n_split] = mx;
      part_l[part_base + (int64_t)g * n_split] = sum;
    }
  }
}

// acc[g][d] = sum_r p[g][r] * v[r][d] over the staged (zero-filled) rows of
// pitch `ld` elements.
template <int DH, typename T>
__device__ void chunk_pv(const T* sv, int ld, float (*sp)[kChunk], int G, float* part_acc,
                         int64_t part_base, int n_split) {
  for (int d = threadIdx.x; d < DH; d += kThreads) {
    float acc[kMaxGroup];
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) acc[g] = 0.f;
#pragma unroll 8
    for (int r = 0; r < kChunk; ++r) {
      const float vv = to_float(sv[r * ld + d]);
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < G) acc[g] += sp[g][r] * vv;
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g < G) part_acc[(part_base + (int64_t)g * n_split) * DH + d] = acc[g];
    }
  }
}

// The int8-cache partial kernel: W8A8 = false scores q (fp32 from bf16)
// against the K codes; W8A8 = true quantizes q and scores int8 x int8.
template <int DH, bool W8A8>
__global__ void __launch_bounds__(kThreads)
decode_partial_q8_kernel(const __nv_bfloat16* __restrict__ q,
                         const int8_t* __restrict__ k_stack,
                         const int8_t* __restrict__ v_stack,
                         const __nv_bfloat16* __restrict__ ks_stack,
                         const __nv_bfloat16* __restrict__ vs_stack,
                         const int* __restrict__ pos_p, const int* __restrict__ layer_p,
                         const int* __restrict__ row_start, float* __restrict__ part_m,
                         float* __restrict__ part_l, float* __restrict__ part_acc, int B,
                         int S, int Hq, int Hkv, int kv_width, int n_split, int window,
                         float softcap, float scale) {
  // Code rows of the chunk, 16 bytes of padding per row so a quarter warp
  // reading 8 consecutive rows with 16-byte loads hits distinct banks.
  constexpr int LD = DH + 16;
  constexpr int kVec = 16;  // int8 codes per 16-byte load
  __shared__ __align__(16) int8_t sk[kChunk * LD];
  __shared__ __align__(16) int8_t sv[kChunk * LD];
  __shared__ float sks[kChunk];  // the chunk's K scales (0 outside [lo, hi])
  __shared__ float svs[kChunk];  // the chunk's V scales (0 outside [lo, hi])
  __shared__ float sq[kMaxGroup][DH];
  __shared__ __align__(16) int8_t sq8[kMaxGroup][DH];  // W8A8: q codes
  __shared__ float sqs[kMaxGroup];                     // W8A8: q scales
  __shared__ float sp[kMaxGroup][kChunk];

  const int split = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x;

  const int pos = *pos_p;
  const int layer = *layer_p;
  int lo = max(row_start[b], split * kChunk);
  if (window > 0) lo = max(lo, pos - window + 1);
  const int c0 = split * kChunk;
  const int n_cols = min(kChunk, kv_width - c0);
  const int hi = min(c0 + n_cols - 1, pos);

  const int64_t part_base = ((int64_t)b * Hq + (int64_t)hk * G) * n_split + split;
  if (lo > hi) {
    write_empty_partial<DH>(part_m, part_l, part_acc, part_base, G, n_split);
    return;
  }

  const int64_t kv_pitch = (int64_t)Hkv * DH;  // bytes per slot
  const int64_t code_off = (((int64_t)layer * B + b) * S) * kv_pitch + (int64_t)hk * DH;
  const int8_t* kb = k_stack + code_off;
  const int8_t* vb = v_stack + code_off;
  const int64_t scale_off = (((int64_t)layer * B + b) * Hkv + hk) * S;  // [L, B, Hkv, S]
  const __nv_bfloat16* qb = q + ((int64_t)b * Hq + (int64_t)hk * G) * DH;

  // Stage the chunk: every load issued before any store; rows and scales
  // outside [lo, hi] are selected to zero and never read from the cache.
  constexpr int kLoads = kChunk * (DH / kVec) / kThreads;
  static_assert(kLoads >= 1 && (kChunk * (DH / kVec)) % kThreads == 0, "chunk tiling");
  uint4 kval[kLoads], vval[kLoads];
#pragma unroll
  for (int it = 0; it < kLoads; ++it) {
    const int i = tid + it * kThreads;
    const int c = c0 + i / (DH / kVec);
    const int d = (i % (DH / kVec)) * kVec;
    kval[it] = make_uint4(0u, 0u, 0u, 0u);
    vval[it] = make_uint4(0u, 0u, 0u, 0u);
    if (c >= lo && c <= hi) {
      kval[it] = *reinterpret_cast<const uint4*>(kb + (int64_t)c * kv_pitch + d);
      vval[it] = *reinterpret_cast<const uint4*>(vb + (int64_t)c * kv_pitch + d);
    }
  }
  float ksc = 0.f, vsc = 0.f;
  if (tid < kChunk && c0 + tid >= lo && c0 + tid <= hi) {
    ksc = __bfloat162float(ks_stack[scale_off + c0 + tid]);
    vsc = __bfloat162float(vs_stack[scale_off + c0 + tid]);
  }
#pragma unroll
  for (int it = 0; it < kLoads; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / (DH / kVec);
    const int d = (i % (DH / kVec)) * kVec;
    *reinterpret_cast<uint4*>(sk + r * LD + d) = kval[it];
    *reinterpret_cast<uint4*>(sv + r * LD + d) = vval[it];
  }
  if (tid < kChunk) {
    sks[tid] = ksc;
    svs[tid] = vsc;
  }
  for (int i = tid; i < G * DH; i += kThreads) {
    sq[i / DH][i % DH] = __bfloat162float(qb[i]);
  }
  __syncthreads();

  if (W8A8) {
    // q per (row, head) over its dh values, as ops/quant.quantize_rows_sym:
    // scale = max(amax * (1/127), 1e-30), codes = clamp(rint(q / scale), +-127).
    const int warp = tid >> 5;
    const int lane = tid & 31;
    for (int g = warp; g < G; g += kWarps) {
      float amax = 0.f;
      for (int d = lane; d < DH; d += 32) amax = fmaxf(amax, fabsf(sq[g][d]));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
      }
      const float qs = fmaxf(amax * (1.f / 127.f), 1e-30f);
      for (int d = lane; d < DH; d += 32) {
        sq8[g][d] = static_cast<int8_t>(fminf(fmaxf(rintf(sq[g][d] / qs), -127.f), 127.f));
      }
      if (lane == 0) sqs[g] = qs;
    }
    __syncthreads();
  }

  // Scores, one (slot, query head) pair per thread step, then x K scale x
  // scale (W8A8: the exact int32 dot x q scale first), softcap, mask.
  for (int i = tid; i < kChunk * G; i += kThreads) {
    const int r = i % kChunk;
    const int g = i / kChunk;
    const int c = c0 + r;
    float s = kNegInf;
    if (c >= lo && c <= hi) {
      const int8_t* krow = sk + r * LD;
      if (W8A8) {
        int dot = 0;
#pragma unroll
        for (int d = 0; d < DH; d += kVec) {
          const int4 kw = *reinterpret_cast<const int4*>(krow + d);
          const int4 qw = *reinterpret_cast<const int4*>(&sq8[g][d]);
          dot = __dp4a(qw.x, kw.x, dot);
          dot = __dp4a(qw.y, kw.y, dot);
          dot = __dp4a(qw.z, kw.z, dot);
          dot = __dp4a(qw.w, kw.w, dot);
        }
        s = static_cast<float>(dot) * sqs[g];
        s = s * sks[r];
      } else {
        float acc = 0.f;
#pragma unroll
        for (int d = 0; d < DH; d += kVec) {
          const uint4 raw = *reinterpret_cast<const uint4*>(krow + d);
          const int8_t* code = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc += sq[g][d + e] * static_cast<float>(code[e]);
        }
        s = acc * sks[r];
      }
      s = s * scale;
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
    }
    sp[g][r] = s;
  }
  __syncthreads();

  chunk_softmax(sp, svs, G, c0, lo, hi, part_m, part_l, part_base, n_split);
  __syncthreads();
  chunk_pv<DH>(sv, LD, sp, G, part_acc, part_base, n_split);
}

// out[b, h] = sum_i exp(m_i - m) acc_i / sum_i exp(m_i - m) l_i over the
// splits of (b, h); 0 when nothing was valid (l sums to 0).
template <int DH>
__global__ void __launch_bounds__(kThreads)
decode_merge_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                    const float* __restrict__ part_acc, __nv_bfloat16* __restrict__ out,
                    float* __restrict__ m_out, float* __restrict__ l_out, int n_split) {
  const int64_t bh = blockIdx.x;  // b * Hq + h
  const float* pm = part_m + bh * n_split;
  const float* pl = part_l + bh * n_split;
  float m = kNegInf;
  for (int i = 0; i < n_split; ++i) m = fmaxf(m, pm[i]);
  float l = 0.f;
  for (int i = 0; i < n_split; ++i) l += pl[i] * expf(pm[i] - m);
  const float inv = (l == 0.f) ? 0.f : 1.f / l;
  if (m_out != nullptr && threadIdx.x == 0) {
    m_out[bh] = m;
    l_out[bh] = l;
  }
  for (int d = threadIdx.x; d < DH; d += kThreads) {
    float acc = 0.f;
    for (int i = 0; i < n_split; ++i) {
      const float w = pl[i] == 0.f ? 0.f : expf(pm[i] - m);
      acc += w * part_acc[(bh * n_split + i) * DH + d];
    }
    out[bh * DH + d] = __float2bfloat16(acc * inv);
  }
}

template <int DH>
cudaError_t launch_merge(void* part_m, void* part_l, void* part_acc, void* out, void* m_out,
                         void* l_out, int B, int Hq, int n_split, cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();  // the partial kernel's launch
  if (err != cudaSuccess) return err;
  decode_merge_kernel<DH><<<B * Hq, kThreads, 0, stream>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(m_out), static_cast<float*>(l_out), n_split);
  return cudaGetLastError();
}

// ---- the bf16 cache: one launch per call ------------------------------------

constexpr int kDecWarps = 8;                  // warps of a bf16 CTA
constexpr int kDecThreads = kDecWarps * 32;
constexpr int kDecChunk = 16 * kDecWarps;     // kv slots per chunk: 16 per warp
constexpr int kStages = 3;                    // cp.async ring depth
constexpr int kMaxSplit = 512;                // splits per (row, kv head) the fused merge holds
constexpr float kLog2e = 1.4426950408889634f;

template <int DH>
struct Bf16Smem {
  static constexpr int LD = DH + 8;            // bf16 row pitch: ldmatrix rows hit distinct banks
  static constexpr int TILE = kDecChunk * LD;  // elements of one K or V chunk
  static constexpr int RING = kStages * 2 * TILE * 2;          // bytes
  static constexpr int LDO = DH + 4;           // fp32 pitch of the warps' merge buffer
  static constexpr int O_BYTES = kDecWarps * 16 * LDO * 4;
  static constexpr int STAT_BYTES = 2 * kDecWarps * 16 * 4;    // per-warp m and l of 16 rows
  // After the loop the ring holds the warps' O and (m, l), the split weights
  // and (M, l) of each head, then the split lanes' float4 sums.
  __host__ __device__ static int sum_offset(int n_split) {
    return (O_BYTES + STAT_BYTES + (kMaxGroup * n_split + 2 * kMaxGroup) * 4 + 15) & ~15;
  }
  __host__ __device__ static int bytes(int n_split) {
    const int merge = sum_offset(n_split) + kDecThreads * kMaxGroup * 16;
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// One CTA per (split, kv head, batch row). The split covers slots
// [split * kv_width / n_split, (split + 1) * kv_width / n_split); the CTA
// streams the valid part of it (inside [row_start, pos] and the window) in
// 128-slot chunks through a 3-stage cp.async ring, invalid rows zero-filled
// and never read. The group's query heads are the 16 rows of an
// mma.sync m16n8k16 A operand held in registers (zero past G); each of the
// eight warps scores 16 slots of a chunk against them and keeps its own
// online softmax and O fragment in registers across the chunks. The warps
// merge through shared memory at the end. With one split the CTA writes the
// output; otherwise it writes an fp32 partial and takes a ticket, and the
// last CTA of the (row, kv head) merges the partials and resets the ticket.
template <int DH>
__global__ void __launch_bounds__(kDecThreads)
decode_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_stack,
                   const __nv_bfloat16* __restrict__ v_stack, const int* __restrict__ pos_p,
                   const int* __restrict__ layer_p, const int* __restrict__ row_start,
                   float* __restrict__ part_m, float* __restrict__ part_l,
                   float* __restrict__ part_acc, int* __restrict__ tickets,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ m_out,
                   float* __restrict__ l_out, int B, int S, int Hq, int Hkv, int kv_width,
                   int n_split, int window, float softcap, float scale) {
  using L = Bf16Smem<DH>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  __shared__ int s_last;

  const int split = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g8 = lane >> 2;  // fragment rows g8 and g8 + 8: query heads of the group
  const int quad = lane & 3;

  // q of the group as A fragments, loaded once (rows past G are zero);
  // issued first, as it does not wait on pos.
  const __nv_bfloat16* qb = q + (static_cast<int64_t>(b) * Hq + static_cast<int64_t>(hk) * G) * DH;
  uint32_t qa[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const int c = 16 * kk + 2 * quad;
    qa[kk][0] = g8 < G ? load_pair(qb + g8 * DH + c) : 0u;
    qa[kk][1] = g8 + 8 < G ? load_pair(qb + (g8 + 8) * DH + c) : 0u;
    qa[kk][2] = g8 < G ? load_pair(qb + g8 * DH + c + 8) : 0u;
    qa[kk][3] = g8 + 8 < G ? load_pair(qb + (g8 + 8) * DH + c + 8) : 0u;
  }

  const int pos = *pos_p;
  const int layer = *layer_p;
  int lo = row_start[b];
  if (window > 0) lo = max(lo, pos - window + 1);
  const int first = max(lo, static_cast<int>(static_cast<int64_t>(split) * kv_width / n_split));
  const int last =
      min(pos, static_cast<int>(static_cast<int64_t>(split + 1) * kv_width / n_split) - 1);
  const int n_chunks = first <= last ? (last - first) / kDecChunk + 1 : 0;

  const int64_t kv_pitch = static_cast<int64_t>(Hkv) * DH;
  const int64_t layer_off =
      ((static_cast<int64_t>(layer) * B + b) * S) * kv_pitch + static_cast<int64_t>(hk) * DH;
  const __nv_bfloat16* kb = k_stack + layer_off;
  const __nv_bfloat16* vb = v_stack + layer_off;

  constexpr int kSegs = DH / 8;  // 16-byte segments per slot row
  auto issue = [&](int c) {
    __nv_bfloat16* sk = ring + (c % kStages) * 2 * L::TILE;
    __nv_bfloat16* sv = sk + L::TILE;
    const int c0 = first + c * kDecChunk;
#pragma unroll
    for (int it = 0; it < kDecChunk * kSegs / kDecThreads; ++it) {
      const int i = tid + it * kDecThreads;
      const int r = i / kSegs;
      const int d = (i % kSegs) * 8;
      const bool ok = c0 + r <= last;
      const int64_t off = static_cast<int64_t>(ok ? c0 + r : first) * kv_pitch + d;
      cp_async16(sk + r * L::LD + d, kb + off, ok);
      cp_async16(sv + r * L::LD + d, vb + off, ok);
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
    const __nv_bfloat16* sk = ring + (c % kStages) * 2 * L::TILE;
    const __nv_bfloat16* sv = sk + L::TILE;
    const int row = 16 * warp;  // this warp's 16 slots of the chunk

    // S = q K^T over the warp's slots: two n8 tiles.
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t kf[4];
      ldmatrix_x4(kf, sk + (row + (lane >> 4) * 8 + (lane & 7)) * L::LD + kk * 16 +
                          ((lane >> 3) & 1) * 8);
      mma_bf16(s[0], qa[kk], kf[0], kf[1]);
      mma_bf16(s[1], qa[kk], kf[2], kf[3]);
    }

    // Scale, softcap, mask; online softmax of rows g8 and g8 + 8.
    const int c0 = first + c * kDecChunk + row;
    bool valid[2][2];
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const bool ok = c0 + 8 * j + 2 * quad + (e & 1) <= last;
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
    const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                            pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};

    // O = alpha O + P V over the warp's 16 slots.
#pragma unroll
    for (int nn = 0; nn < DH / 16; ++nn) {
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, sv + (row + ((lane >> 3) & 1) * 8 + (lane & 7)) * L::LD + nn * 16 +
                                (lane >> 4) * 8);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* a = acc[2 * nn + h];
        a[0] *= alpha0;
        a[1] *= alpha0;
        a[2] *= alpha1;
        a[3] *= alpha1;
        mma_bf16(acc[2 * nn + h], pa, vf[2 * h], vf[2 * h + 1]);
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
  float* sL = sM + kDecWarps * 16;                               // [warp][16]
  if (quad == 0) {
    sM[warp * 16 + g8] = m0;
    sM[warp * 16 + g8 + 8] = m1;
    sL[warp * 16 + g8] = l0;
    sL[warp * 16 + g8 + 8] = l1;
  }
  __syncthreads();
  float M0 = kNegInf, M1 = kNegInf;
#pragma unroll
  for (int w = 0; w < kDecWarps; ++w) {
    M0 = fmaxf(M0, sM[w * 16 + g8]);
    M1 = fmaxf(M1, sM[w * 16 + g8 + 8]);
  }
  const float f0 = exp2f((m0 - M0) * kLog2e), f1 = exp2f((m1 - M1) * kLog2e);
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    const int col = 8 * n + 2 * quad;
    float* o0 = sO + (warp * 16 + g8) * L::LDO + col;
    float* o1 = o0 + 8 * L::LDO;
    o0[0] = acc[n][0] * f0;
    o0[1] = acc[n][1] * f0;
    o1[0] = acc[n][2] * f1;
    o1[1] = acc[n][3] * f1;
  }
  __syncthreads();

  const int64_t head0 = static_cast<int64_t>(b) * Hq + static_cast<int64_t>(hk) * G;
  for (int i = tid; i < G * DH; i += kDecThreads) {
    const int g = i / DH, d = i % DH;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) M = fmaxf(M, sM[w * 16 + g]);
    float l = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      l += sL[w * 16 + g] * exp2f((sM[w * 16 + g] - M) * kLog2e);
      o += sO[(w * 16 + g) * L::LDO + d];
    }
    if (n_split == 1) {
      out[(head0 + g) * DH + d] = __float2bfloat16(l == 0.f ? 0.f : o / l);
      if (m_out != nullptr && d == 0) {
        m_out[head0 + g] = M;
        l_out[head0 + g] = l;
      }
    } else {
      const int64_t pi = (head0 + g) * n_split + split;
      part_acc[pi * DH + d] = o;
      if (d == 0) {
        part_m[pi] = M;
        part_l[pi] = l;
      }
    }
  }
  if (n_split == 1) return;

  // Ticket: the last CTA of this (row, kv head) to finish merges the splits.
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&tickets[b * Hkv + hk], 1) == n_split - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  float* sW = sL + kDecWarps * 16;          // [G][n_split]: e^(m_s - M)
  float* sStat = sW + kMaxGroup * n_split;  // [G][2]: M, l
  for (int g = warp; g < G; g += kDecWarps) {
    const int64_t pb = (head0 + g) * n_split;
    float M = kNegInf;
    for (int sp = lane; sp < n_split; sp += 32) M = fmaxf(M, __ldcg(part_m + pb + sp));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    float l = 0.f;
    for (int sp = lane; sp < n_split; sp += 32) {
      const float pl = __ldcg(part_l + pb + sp);
      const float w = pl == 0.f ? 0.f : exp2f((__ldcg(part_m + pb + sp) - M) * kLog2e);
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
  // share of the splits (kDecThreads / (DH / 4) split lanes), so its loads are
  // independent 16-byte loads; the lanes then add up through shared memory.
  constexpr int kCols = DH / 4;               // float4 columns of a row
  constexpr int kLanes = kDecThreads / kCols; // split lanes per column
  float4* sSum = reinterpret_cast<float4*>(smem + L::sum_offset(n_split));  // [kLanes][G][kCols]
  const int col = tid % kCols, sl = tid / kCols;
  for (int g = 0; g < G; ++g) {
    const float4* pa = reinterpret_cast<const float4*>(part_acc + (head0 + g) * n_split * DH);
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
  for (int i = tid; i < G * kCols; i += kDecThreads) {
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
    __nv_bfloat16* dst = out + (head0 + g) * DH + 4 * c;
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(o.x * inv, o.y * inv);
    *reinterpret_cast<__nv_bfloat162*>(dst + 2) = __floats2bfloat162_rn(o.z * inv, o.w * inv);
    if (m_out != nullptr && c == 0) {
      m_out[head0 + g] = sStat[2 * g];
      l_out[head0 + g] = l;
    }
  }
  if (tid == 0) tickets[b * Hkv + hk] = 0;  // ready for the next launch (and graph replay)
}

template <int DH>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* pos,
                        const void* layer, const void* row_start, void* part_m, void* part_l,
                        void* part_acc, void* tickets, void* out, void* m_out, void* l_out, int B,
                        int S, int Hq, int Hkv, int kv_width, int n_split, int window,
                        float softcap, float scale, cudaStream_t stream) {
  const int bytes = Bf16Smem<DH>::bytes(n_split);
  cudaError_t err = cudaFuncSetAttribute(decode_bf16_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(n_split, Hkv, B);
  decode_bf16_kernel<DH><<<grid, kDecThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(pos),
      static_cast<const int*>(layer), static_cast<const int*>(row_start),
      static_cast<float*>(part_m), static_cast<float*>(part_l), static_cast<float*>(part_acc),
      static_cast<int*>(tickets), static_cast<__nv_bfloat16*>(out), static_cast<float*>(m_out),
      static_cast<float*>(l_out), B, S, Hq, Hkv, kv_width, n_split, window, softcap, scale);
  return cudaGetLastError();
}

template <int DH, bool W8A8>
cudaError_t launch_q8(const void* q, const void* k, const void* v, const void* ks,
                      const void* vs, const void* pos, const void* layer,
                      const void* row_start, void* part_m, void* part_l, void* part_acc,
                      void* out, void* m_out, void* l_out, int B, int S, int Hq, int Hkv,
                      int kv_width, int n_split, int window, float softcap, float scale,
                      cudaStream_t stream) {
  dim3 grid(n_split, Hkv, B);
  decode_partial_q8_kernel<DH, W8A8><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const __nv_bfloat16*>(ks),
      static_cast<const __nv_bfloat16*>(vs), static_cast<const int*>(pos),
      static_cast<const int*>(layer), static_cast<const int*>(row_start),
      static_cast<float*>(part_m), static_cast<float*>(part_l), static_cast<float*>(part_acc),
      B, S, Hq, Hkv, kv_width, n_split, window, softcap, scale);
  return launch_merge<DH>(part_m, part_l, part_acc, out, m_out, l_out, B, Hq, n_split,
                         stream);
}

bool bad_group(int Hq, int Hkv) { return Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxGroup; }

// The int8 kernels: one 64-slot chunk per split.
bool bad_shape(int Hq, int Hkv, int kv_width, int n_split) {
  return bad_group(Hq, Hkv) || n_split * kChunk < kv_width;
}

template <bool W8A8>
int dispatch_q8(const void* q, const void* k, const void* v, const void* ks, const void* vs,
                const void* pos, const void* layer, const void* row_start, void* part_m,
                void* part_l, void* part_acc, void* out, void* m_out, void* l_out, int B, int S,
                int Hq, int Hkv, int dh, int kv_width, int n_split, int window, float softcap,
                float scale, void* stream) {
  if (bad_shape(Hq, Hkv, kv_width, n_split)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32:
      return launch_q8<32, W8A8>(q, k, v, ks, vs, pos, layer, row_start, part_m, part_l,
                                 part_acc, out, m_out, l_out, B, S, Hq, Hkv, kv_width,
                                 n_split, window, softcap, scale, st);
    case 64:
      return launch_q8<64, W8A8>(q, k, v, ks, vs, pos, layer, row_start, part_m, part_l,
                                 part_acc, out, m_out, l_out, B, S, Hq, Hkv, kv_width,
                                 n_split, window, softcap, scale, st);
    case 128:
      return launch_q8<128, W8A8>(q, k, v, ks, vs, pos, layer, row_start, part_m, part_l,
                                  part_acc, out, m_out, l_out, B, S, Hq, Hkv, kv_width,
                                  n_split, window, softcap, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q [B, 1, Hq, dh]; k/v [L, B, S, Hkv, dh]; out [B, 1, Hq, dh]: bf16,
// contiguous. pos and layer are int32 device scalars, row_start an int32
// device vector [B]. n_split (1 to 512, at most kv_width) is the host's split
// plan (ops/kernels/decode_attention.split_plan); with n_split > 1, part_m /
// part_l are fp32 scratch [B, Hq, n_split], part_acc fp32 scratch
// [B, Hq, n_split, dh] and tickets an int32 buffer of at least B * Hkv zeros
// that the kernel leaves zero (any of them may be NULL when n_split is 1).
// m_out / l_out are fp32 [B, Hq] (the softmax state), or both NULL.
// window <= 0 disables the sliding window, softcap <= 0 the softcap.
// Returns the cudaError_t of the launch (0 on success).
int llmc_decode_attention_bf16(const void* q, const void* k, const void* v, const void* pos,
                               const void* layer, const void* row_start, void* part_m,
                               void* part_l, void* part_acc, void* tickets, void* out,
                               void* m_out, void* l_out, int B, int S, int Hq, int Hkv, int dh,
                               int kv_width, int n_split, int window, float softcap, float scale,
                               void* stream) {
  if (bad_group(Hq, Hkv) || n_split < 1 || n_split > kMaxSplit || n_split > kv_width) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32:
      return launch_bf16<32>(q, k, v, pos, layer, row_start, part_m, part_l, part_acc, tickets,
                             out, m_out, l_out, B, S, Hq, Hkv, kv_width, n_split, window, softcap,
                             scale, st);
    case 64:
      return launch_bf16<64>(q, k, v, pos, layer, row_start, part_m, part_l, part_acc, tickets,
                             out, m_out, l_out, B, S, Hq, Hkv, kv_width, n_split, window, softcap,
                             scale, st);
    case 128:
      return launch_bf16<128>(q, k, v, pos, layer, row_start, part_m, part_l, part_acc, tickets,
                              out, m_out, l_out, B, S, Hq, Hkv, kv_width, n_split, window,
                              softcap, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The int8 cache: k/v codes [L, B, S, Hkv, dh] int8, ks/vs scales
// [L, B, Hkv, S] bf16 (seq-minor); everything else as above.
int llmc_decode_attention_int8(const void* q, const void* k, const void* v, const void* ks,
                               const void* vs, const void* pos, const void* layer,
                               const void* row_start, void* part_m, void* part_l,
                               void* part_acc, void* out, void* m_out, void* l_out, int B, int S,
                               int Hq, int Hkv, int dh, int kv_width, int n_split, int window,
                               float softcap, float scale, void* stream) {
  return dispatch_q8<false>(q, k, v, ks, vs, pos, layer, row_start, part_m, part_l, part_acc,
                            out, m_out, l_out, B, S, Hq, Hkv, dh, kv_width, n_split, window,
                            softcap, scale, stream);
}

// The int8 cache with int8 x int8 scores (q quantized per head in-kernel).
int llmc_decode_attention_int8_w8a8(const void* q, const void* k, const void* v,
                                    const void* ks, const void* vs, const void* pos,
                                    const void* layer, const void* row_start, void* part_m,
                                    void* part_l, void* part_acc, void* out, void* m_out,
                                    void* l_out, int B, int S, int Hq, int Hkv, int dh,
                                    int kv_width, int n_split, int window, float softcap,
                                    float scale, void* stream) {
  return dispatch_q8<true>(q, k, v, ks, vs, pos, layer, row_start, part_m, part_l, part_acc,
                           out, m_out, l_out, B, S, Hq, Hkv, dh, kv_width, n_split, window,
                           softcap, scale, stream);
}

}  // extern "C"
