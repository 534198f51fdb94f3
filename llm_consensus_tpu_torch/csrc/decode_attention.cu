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
// Three variants, each a partial kernel beside one shared merge kernel:
//   * bf16 cache k/v [L, B, S, Hkv, dh] (decode_partial_kernel);
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
// one layer once (2 * n_valid * Hkv * dh bytes of int8 codes plus 4 * n_valid
// * Hkv bytes of scales, or twice the codes' bytes in bf16) and does ~4
// operations per element read, far below the ~295 FLOPs/byte ridge. At
// batch 1 the TPU kernel's one-program-per-(row, kv head) form would occupy
// 8 of 132 SMs, so the design splits the kv span into 64-slot chunks
// (flash-decoding): one CTA per (chunk, kv head, batch row) stages its
// chunk's K/V rows (and, for int8, the chunk's two scale rows) in shared
// memory with independent 16-byte loads (one memory latency, each row read
// once and shared by the g query heads of the kv head), scores it, writes
// a partial (m, l, acc), and a second small kernel merges the partials
// exactly (o = sum_i w_i acc_i / sum_i w_i l_i, w_i = exp(m_i - m)). Slots
// outside [row_start, pos] are masked out of the scores and never loaded:
// their V rows (bf16) or V scales (int8) are selected to zero, so NaN in
// unwritten slots cannot reach the output; a row with nothing valid
// outputs 0. The int8 chunk stages half the bytes of the bf16 one.
//
// return_state (every variant; the TPU kernel's return_state=True, for the
// shared-prefix decode path's two-source merge): the merge kernel already
// holds each (row, query head)'s global softmax state, so when m_out/l_out
// are non-null it writes it beside the output, fp32 [B, Hq], in the same
// launch: m = the max of the scaled, softcapped, masked scores; l = the sum
// of exp(s - m) over valid slots, taken before the int8 V scale folds into
// p (chunk_softmax sums first, then scales). A row with no valid slot
// writes m = -1e30 and l = 0. The output is the bf16-rounded normalized
// attention, as the TPU kernel's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChunk = 64;    // kv slots per CTA
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 16; // query heads per kv head
constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value

__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
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

template <int DH>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k_stack,
                      const __nv_bfloat16* __restrict__ v_stack,
                      const int* __restrict__ pos_p, const int* __restrict__ layer_p,
                      const int* __restrict__ row_start, float* __restrict__ part_m,
                      float* __restrict__ part_l, float* __restrict__ part_acc, int B,
                      int S, int Hq, int Hkv, int kv_width, int n_split, int window,
                      float softcap, float scale) {
  // K/V rows of the chunk, padded so lanes reading consecutive rows with
  // 16-byte loads hit distinct shared-memory banks.
  constexpr int LD = DH + 8;
  constexpr int kVec = 8;  // bf16 values per 16-byte load
  __shared__ __align__(16) __nv_bfloat16 sk[kChunk * LD];
  __shared__ __align__(16) __nv_bfloat16 sv[kChunk * LD];
  __shared__ float sq[kMaxGroup][DH];
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
  const int n_cols = min(kChunk, kv_width - c0);  // slots of this chunk in the span
  const int hi = min(c0 + n_cols - 1, pos);       // inclusive

  // Partial outputs of (b, q head hk*G + g, split).
  const int64_t part_base = ((int64_t)b * Hq + (int64_t)hk * G) * n_split + split;
  if (lo > hi) {
    write_empty_partial<DH>(part_m, part_l, part_acc, part_base, G, n_split);
    return;
  }

  const int64_t kv_pitch = (int64_t)Hkv * DH;
  const int64_t layer_off = (((int64_t)layer * B + b) * S) * kv_pitch + (int64_t)hk * DH;
  const __nv_bfloat16* kb = k_stack + layer_off;
  const __nv_bfloat16* vb = v_stack + layer_off;
  const __nv_bfloat16* qb = q + ((int64_t)b * Hq + (int64_t)hk * G) * DH;

  // Stage the chunk: all of a thread's loads are issued before any store,
  // so the chunk costs one memory latency; rows outside [lo, hi] are
  // selected to zero and never read from the cache.
  constexpr int kLoads = kChunk * (DH / kVec) / kThreads;
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
#pragma unroll
  for (int it = 0; it < kLoads; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / (DH / kVec);
    const int d = (i % (DH / kVec)) * kVec;
    *reinterpret_cast<uint4*>(sk + r * LD + d) = kval[it];
    *reinterpret_cast<uint4*>(sv + r * LD + d) = vval[it];
  }
  for (int i = tid; i < G * DH; i += kThreads) {
    sq[i / DH][i % DH] = __bfloat162float(qb[i]);
  }
  __syncthreads();

  // Scores, one (slot, query head) pair per thread step: q.k in fp32 from
  // bf16 values, scaled, softcapped, masked.
  for (int i = tid; i < kChunk * G; i += kThreads) {
    const int r = i % kChunk;
    const int g = i / kChunk;
    const int c = c0 + r;
    float s = kNegInf;
    if (c >= lo && c <= hi) {
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < DH; d += kVec) {
        const uint4 raw = *reinterpret_cast<const uint4*>(sk + r * LD + d);
        const __nv_bfloat162* pair = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int e = 0; e < kVec / 2; ++e) {
          const float2 kf = __bfloat1622float2(pair[e]);
          acc += sq[g][d + 2 * e] * kf.x + sq[g][d + 2 * e + 1] * kf.y;
        }
      }
      s = acc * scale;
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
    }
    sp[g][r] = s;
  }
  __syncthreads();

  chunk_softmax(sp, nullptr, G, c0, lo, hi, part_m, part_l, part_base, n_split);
  __syncthreads();
  chunk_pv<DH>(sv, LD, sp, G, part_acc, part_base, n_split);
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

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* pos,
                   const void* layer, const void* row_start, void* part_m, void* part_l,
                   void* part_acc, void* out, void* m_out, void* l_out, int B, int S, int Hq,
                   int Hkv, int kv_width, int n_split, int window, float softcap, float scale,
                   cudaStream_t stream) {
  dim3 grid(n_split, Hkv, B);
  decode_partial_kernel<DH><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(pos),
      static_cast<const int*>(layer), static_cast<const int*>(row_start),
      static_cast<float*>(part_m), static_cast<float*>(part_l), static_cast<float*>(part_acc),
      B, S, Hq, Hkv, kv_width, n_split, window, softcap, scale);
  return launch_merge<DH>(part_m, part_l, part_acc, out, m_out, l_out, B, Hq, n_split,
                         stream);
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

bool bad_shape(int Hq, int Hkv, int kv_width, int n_split) {
  return Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxGroup || n_split * kChunk < kv_width;
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
// device vector [B]. part_m / part_l are fp32 scratch [B, Hq, n_split] and
// part_acc fp32 scratch [B, Hq, n_split, dh], n_split = ceil(kv_width /
// 64). m_out / l_out are fp32 [B, Hq] (the softmax state), or both NULL.
// window <= 0 disables the sliding window, softcap <= 0 the softcap.
// Returns the cudaError_t of the launches (0 on success).
int llmc_decode_attention_bf16(const void* q, const void* k, const void* v, const void* pos,
                               const void* layer, const void* row_start, void* part_m,
                               void* part_l, void* part_acc, void* out, void* m_out,
                               void* l_out, int B, int S, int Hq, int Hkv, int dh, int kv_width,
                               int n_split, int window, float softcap, float scale,
                               void* stream) {
  if (bad_shape(Hq, Hkv, kv_width, n_split)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32:
      return launch<32>(q, k, v, pos, layer, row_start, part_m, part_l, part_acc, out, m_out,
                        l_out, B, S, Hq, Hkv, kv_width, n_split, window, softcap, scale, st);
    case 64:
      return launch<64>(q, k, v, pos, layer, row_start, part_m, part_l, part_acc, out, m_out,
                        l_out, B, S, Hq, Hkv, kv_width, n_split, window, softcap, scale, st);
    case 128:
      return launch<128>(q, k, v, pos, layer, row_start, part_m, part_l, part_acc, out, m_out,
                         l_out, B, S, Hq, Hkv, kv_width, n_split, window, softcap, scale, st);
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
