"""B2 and B7 at the serving shapes, for one checkout's kernels: bf16 and
float32 K/V and, where the checkout has them, the int8 KV cache's int8
K/V under bf16 and under float32 queries.

``chip_smoke.py`` times these shapes for the tree it runs from; this
module also runs against another checkout's ``src`` (a parent commit's
``git archive``), so two checkouts are timed in one call on one card:

    python3 src/repro_torch/bench/attention_times.py --src .chip_parent/src

Shapes (qwen3-1.7b: Hq 16, Hkv 8, D 128): prefill Sq = Skv = 512,
causal; a prefill chunk (Sq 128 at offset 384, kv_len 512 of a 1 024-key
buffer); slot-cache decode (4 rows of Sq 1, kv_len 17/64/200/511 of a
1 024-key buffer).  Each row: B2's CUDA-event median and a sha256 of its
output bytes on seeded inputs, so two checkouts' bits can be compared;
the float32 and int8 rows add B7's median and digest at prefill (float32:
the same inputs in float32).  Needs a card.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

HQ, HKV, D, BUFFER = 16, 8, 128, 1024
# name -> (rows, Sq, kv_len per row, keys in the buffer)
SHAPES = {"prefill": (1, 512, [512], 512),
          "chunk": (1, 128, [512], BUFFER),
          "slot_decode": (4, 1, [17, 64, 200, 511], BUFFER)}


def _digest(t) -> str:
    import torch

    return hashlib.sha256(t.view(torch.int16).cpu().numpy().tobytes()
                          ).hexdigest()[:16]


def rows(timer, dev: str = "cuda"):
    import torch

    from repro_torch.core import quant
    from repro_torch.kernels import attention_df

    int8 = hasattr(attention_df, "FLASH_I8KV")
    f32_int8 = hasattr(attention_df, "FLASH_F32_I8KV")
    out = []
    for name, (b, sq, lens, skv) in SHAPES.items():
        gen = torch.Generator(device=dev).manual_seed(sq + skv)
        q = torch.randn((b, HQ, sq, D), generator=gen, device=dev).to(
            torch.bfloat16)
        k, v = (torch.randn((b, HKV, skv, D), generator=gen, device=dev).to(
            torch.bfloat16) for _ in range(2))
        kv = (lens[0] if b == 1
              else torch.tensor(lens, device=dev, dtype=torch.int32))
        row = {"shape": f"{name} B={b} Sq={sq} kv_len={lens} Skv={skv} "
                        f"Hq={HQ} Hkv={HKV} D={D}"}
        flash = lambda: attention_df.flash_attention(q, k, v, kv_len=kv)
        row["bf16_flash_ms"] = timer.ms(flash)
        row["bf16_flash_sha256"] = _digest(flash())
        if int8:
            (kq, ks), (vq, vs) = (quant.symmetric_int8(k, -1),
                                  quant.symmetric_int8(v, -1))
            i8 = dict(kv_len=kv, k_scale=ks, v_scale=vs)
            flash8 = lambda: attention_df.flash_attention(q, kq, vq, **i8)
            row["int8_flash_ms"] = timer.ms(flash8)
            row["int8_flash_sha256"] = _digest(flash8())
            if name == "prefill":
                kv8 = lambda: attention_df.kv_stationary_attention(
                    q, kq, vq, **i8)
                row["int8_kv_stationary_ms"] = timer.ms(kv8)
                row["int8_kv_stationary_sha256"] = _digest(kv8())
        qf, kf, vf = q.float(), k.float(), v.float()
        flash32 = lambda: attention_df.flash_attention(qf, kf, vf, kv_len=kv)
        row["f32_flash_ms"] = timer.ms(flash32)
        row["f32_flash_sha256"] = _digest(flash32())
        if name == "prefill":
            kv32 = lambda: attention_df.kv_stationary_attention(qf, kf, vf)
            row["f32_kv_stationary_ms"] = timer.ms(kv32)
            row["f32_kv_stationary_sha256"] = _digest(kv32())
        if f32_int8:
            (kq, ks), (vq, vs) = (quant.symmetric_int8(kf, -1),
                                  quant.symmetric_int8(vf, -1))
            i8 = dict(kv_len=kv, k_scale=ks, v_scale=vs)
            k1 = lambda: attention_df.flash_attention(qf, kq, vq, **i8)
            row["f32_int8_flash_ms"] = timer.ms(k1)
            row["f32_int8_flash_sha256"] = _digest(k1())
            if name == "prefill":
                k2 = lambda: attention_df.kv_stationary_attention(
                    qf, kq, vq, **i8)
                row["f32_int8_kv_stationary_ms"] = timer.ms(k2)
                row["f32_int8_kv_stationary_sha256"] = _digest(k2())
        out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."),
        help="the src directory whose repro_torch is timed")
    args = ap.parse_args(argv)
    src = os.path.abspath(args.src)
    sys.path.insert(0, src)
    import torch

    if not torch.cuda.is_available():
        print("attention_times: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.bench import common

    timer = common.Timer("cuda")
    card = common.card_line()
    for row in rows(timer):
        print(json.dumps({"bench": "attention_times", "src": src,
                          "card": card, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
