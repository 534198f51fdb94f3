#!/usr/bin/env python3
"""Time variants of the int8-cache decode kernel against the shipped one,
on one CUDA card.

    python3 tools/decode_int8_variants.py

Each variant is ``llm_consensus_tpu_torch/csrc/decode_attention.cu`` with a
text patch applied, built with the port's nvcc flags into a library of its
own (linked with the shipped flash kernel, so the port's bindings load it)
under ``build/kernels/variants/``, and called through the port's wrapper on
the same inputs. Variants:

  * ``shipped``: the source as it is (P.V's B operand built in registers
    from vector loads of neighbouring slot rows, paired with __byte_perm);
  * ``v_smem_tile``: each arrived V chunk converted once, by every thread
    of the CTA, into a bf16 tile in shared memory, then read with
    ldmatrix.trans as the bf16 kernel reads V (one more barrier a chunk);
  * ``skip_rescale``: P.V skips the rescale of O when no row of the warp
    raised its running max;
  * ``stages_2``, ``stages_4``, ``stages_6``: the cp.async ring 2, 4 or 6
    chunks deep instead of 3 (the bf16 kernel of such a library is not
    called: at 6 stages it would not fit in shared memory);
  * ablations, whose output is wrong and whose time shows what a piece of
    the chunk loop costs: ``no_v_convert``, ``no_k_convert`` (int8 scores
    on the raw codes), ``no_pv_mma`` (P.V products replaced by one add).

Device time per call from CUDA-graph replay, warm and cold (L2 flushed),
as chip_smoke.py measures it, at llama-3-8b's decode shapes: q[1,1,32,128]
over an int8 cache [2,1,8192,8,128] at widths 384 and 8,192, and the
``return_state`` form at q[4,1,32,128] over [2,4,8192,8,128] at 8,192.
Variants run in turns (the list, then the list reversed), and each time is
the mean of its two runs. Prints the card, then one line per case and
variant, then one JSON object. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PATCHES = {
    "shipped": [],
    "v_smem_tile": [
        ("  static constexpr int RING = kStages * STAGE;",
         "  static constexpr int RING =\n"
         "      kStages * STAGE + (C == Cache::kBf16 ? 0 : Geo::CHUNK * (DH * 2 + 16));"),
        ("    constexpr bool kEarlyV = kQuant && !Geo::LEAN;\n"
         "    [[maybe_unused]] uint32_t vb[kEarlyV ? DH / 8 : 1][2];\n"
         "    if constexpr (kEarlyV) {",
         "    constexpr bool kEarlyV = false;\n"
         "    unsigned char* vtile = smem + kStages * L::STAGE;\n"
         "    if constexpr (kQuant) {\n"
         "      for (int i = tid; i < kChunk * DH / 4; i += kThreads) {\n"
         "        const int r = i / (DH / 4), d = (i % (DH / 4)) * 4;\n"
         "        uint32_t lo, hi;\n"
         "        codes_to_bf16(*reinterpret_cast<const uint32_t*>(sv + r * L::LD + d), lo, hi);\n"
         "        *reinterpret_cast<uint2*>(vtile + r * (DH * 2 + 16) + 2 * d) =\n"
         "            make_uint2(lo, hi);\n"
         "      }\n"
         "      __syncthreads();\n"
         "    }\n"
         "    [[maybe_unused]] uint32_t vb[1][2];\n"
         "    if constexpr (false) {"),
        ("          mma_bf16(acc[4 * w + t], pa, b0[t], b1[t]);",
         "          (void)o;\n"
         "        }\n"
         "      }\n"
         "#pragma unroll\n"
         "      for (int nn = 0; nn < DH / 16; ++nn) {\n"
         "        uint32_t vf[4];\n"
         "        ldmatrix_x4_trans(vf, vtile + (row + ((lane >> 3) & 1) * 8 + (lane & 7)) *\n"
         "                                          (DH * 2 + 16) + nn * 32 + (lane >> 4) * 16);\n"
         "        {\n"
         "          mma_bf16(acc[2 * nn], pa, vf[0], vf[1]);\n"
         "          mma_bf16(acc[2 * nn + 1], pa, vf[2], vf[3]);"),
        ("    const int col = kQuant ? 2 * quad * (DH / 8) + n : 8 * n + 2 * quad;\n"
         "    const int next = kQuant ? DH / 8 : 1;",
         "    const int col = 8 * n + 2 * quad;\n"
         "    const int next = 1;"),
    ],
    "skip_rescale": [
        ("    } else {\n#pragma unroll\n      for (int w = 0; w < DH / 32; ++w) {\n",
         "    } else {\n"
         "      const bool same = __all_sync(0xffffffffu, alpha0 == 1.f && alpha1 == 1.f);\n"
         "#pragma unroll\n      for (int w = 0; w < DH / 32; ++w) {\n"),
        ("          o[0] *= alpha0;\n          o[1] *= alpha0;\n          o[2] *= alpha1;\n"
         "          o[3] *= alpha1;\n          mma_bf16(acc[4 * w + t], pa, b0[t], b1[t]);",
         "          if (!same) {\n            o[0] *= alpha0;\n            o[1] *= alpha0;\n"
         "            o[2] *= alpha1;\n            o[3] *= alpha1;\n          }\n"
         "          mma_bf16(acc[4 * w + t], pa, b0[t], b1[t]);"),
    ],
    "stages_2": [("constexpr int kStages = 3;", "constexpr int kStages = 2;")],
    "stages_4": [("constexpr int kStages = 3;", "constexpr int kStages = 4;")],
    "stages_6": [("constexpr int kStages = 3;", "constexpr int kStages = 6;")],
    "no_v_convert": [
        ("        pair_codes(vw[0][w], vw[1][w], b0);\n        pair_codes(vw[2][w], vw[3][w], b1);",
         "        for (int t = 0; t < 4; ++t) {\n"
         "          b0[t] = vw[t & 1][w] + t;\n"
         "          b1[t] = vw[2 + (t & 1)][w] + t;\n"
         "        }"),
    ],
    "no_k_convert": [
        ("          for (int i = 0; i < 4; ++i) codes_to_bf16(kf[i], kb16[i][0], kb16[i][1]);",
         "          for (int i = 0; i < 4; ++i) kb16[i][0] = kf[i], kb16[i][1] = kf[i] >> 1;"),
    ],
    "no_pv_mma": [
        ("          mma_bf16(acc[4 * w + t], pa, b0[t], b1[t]);",
         "          o[0] += __uint_as_float((pa[0] ^ b0[t]) & 0x3f7fffffu);\n"
         "          o[2] += __uint_as_float((pa[1] ^ b1[t]) & 0x3f7fffffu);"),
    ],
}


def patched(src: str, patches: list) -> str:
    for old, new in patches:
        if src.count(old) != 1:
            raise SystemExit(f"patch anchor not found once in the source: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build_variants(out: Path) -> dict:
    """One library per variant, compiled in parallel; returns name -> path."""
    from llm_consensus_tpu_torch.ops.kernels import build

    nvcc = build._nvcc()
    out.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / "decode_attention.cu").read_text()
    jobs = {"flash": (build.CSRC / "flash_attention.cu", out / "flash.o")}
    for name, patches in PATCHES.items():
        path = out / f"{name}.cu"
        path.write_text(patched(src, patches))
        jobs[name] = (path, out / f"{name}.o")
    procs = {name: subprocess.Popen([nvcc, *build.NVCC_FLAGS, "-c", str(s), "-o", str(o)],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name, (s, o) in jobs.items()}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
    libs = {}
    for name in PATCHES:
        lib = out / f"lib{name}.so"
        subprocess.run([nvcc, "-shared", "-Wno-deprecated-gpu-targets", "-o", str(lib),
                        str(jobs["flash"][1]), str(jobs[name][1])], check=True)
        libs[name] = lib
    return libs


def main() -> int:
    import ctypes

    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device visible to torch", file=sys.stderr)
        return 2
    import chip_smoke
    from llm_consensus_tpu_torch.ops.kernels import build
    from llm_consensus_tpu_torch.ops.kernels import decode_attention as da
    from llm_consensus_tpu_torch.ops.quant import quantize_kv

    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)
    t0 = time.monotonic()
    libs = {}
    for name, path in build_variants(ROOT / "build" / "kernels" / "variants").items():
        lib = ctypes.CDLL(str(path))
        build._bind(lib)
        libs[name] = lib
    print(f"build: {time.monotonic() - t0:.1f} s, {len(libs)} variants", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)

    def int8_cache(b):
        x = torch.randn((2, b, 8192, 8, 128), generator=gen, device="cuda", dtype=torch.bfloat16)
        q8, sc = quantize_kv(x)
        return {"q8": q8.contiguous(), "s": sc[..., 0].transpose(2, 3).contiguous()}

    def i32(*x):
        return torch.tensor(x, dtype=torch.int32, device="cuda")

    caches = {1: (int8_cache(1), int8_cache(1)), 4: (int8_cache(4), int8_cache(4))}
    qs = {b: torch.randn((b, 1, 32, 128), generator=gen, device="cuda", dtype=torch.bfloat16)
          for b in (1, 4)}
    cases = [  # (label, batch, pos, width, w8a8, return_state)
        ("int8 B1 w384", 1, 383, 384, False, False),
        ("int8 B1 w8192", 1, 8191, 8192, False, False),
        ("w8a8 B1 w8192", 1, 8191, 8192, True, False),
        ("int8 state B4 w8192", 4, 8191, 8192, False, True),
    ]
    layer = i32(1)[0]
    times: dict = {}
    order = list(libs) + list(reversed(libs))
    shipped = da.ensure_built
    try:
        for name in order:
            da.ensure_built = lambda lib=libs[name]: lib
            for label, b, pos, width, w8a8, state in cases:
                k, v = caches[b]
                pos_t, rs = i32(pos)[0], i32(*([0] * b))

                def call(q=qs[b], k=k, v=v, pos_t=pos_t, rs=rs, width=width, w8a8=w8a8,
                         state=state):
                    return da.decode_attention(q, k, v, pos_t, layer, rs, kv_width=width,
                                               w8a8=w8a8, return_state=state)

                t = chip_smoke.timed(call, 100)
                runs = times.setdefault(label, {}).setdefault(name, {"ms": [], "cold_ms": []})
                runs["ms"].append(t["ms"])
                runs["cold_ms"].append(t["cold_ms"])
    finally:
        da.ensure_built = shipped
    result = {}
    for label, by_name in times.items():
        base = sum(by_name["shipped"]["cold_ms"]) / 2
        for name, runs in by_name.items():
            warm, cold = sum(runs["ms"]) / 2, sum(runs["cold_ms"]) / 2
            result.setdefault(label, {})[name] = {"ms": warm, "cold_ms": cold}
            print(f"{label:22s} {name:14s} warm {warm:.4f} ms, cold {cold:.4f} ms "
                  f"({100 * (cold / base - 1):+.1f} % cold against shipped; runs "
                  f"{', '.join(f'{x:.4f}' for x in runs['cold_ms'])})", flush=True)
    print(json.dumps({"card": card, "variants": result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
