"""B2 and B7 at the serving shapes, for one checkout's kernels: bf16 and
float32 K/V and, where the checkout has them, the int8 KV cache's int8
K/V under bf16 and under float32 queries; and B3 at each served GQA
group.

``chip_smoke.py`` times these shapes for the tree it runs from; this
module also runs against another checkout's ``src`` (a parent commit's
``git archive``), so two checkouts are timed in one call on one card:

    python3 src/repro_torch/bench/attention_times.py --src .chip_parent/src
    python3 src/repro_torch/bench/attention_times.py --kernels paged

Shapes (qwen3-1.7b: Hq 16, Hkv 8, D 128): prefill Sq = Skv = 512,
causal; a prefill chunk (Sq 128 at offset 384, kv_len 512 of a 1 024-key
buffer); slot-cache decode (4 rows of Sq 1, kv_len 17/64/200/511 of a
1 024-key buffer).  Each row: B2's CUDA-event median and a sha256 of its
output bytes on seeded inputs, so two checkouts' bits can be compared;
the float32 and int8 rows add B7's median and digest at prefill (float32:
the same inputs in float32).  B3 (``--kernels paged`` alone: only its
library is built): decode off a page pool, 4 rows at kv_len 0/17/200/527,
page 16, shuffled page ids, D 128, at the served groups (moonshot-v1-16b-a3b
16/16, qwen3-1.7b 16/8, 32/4, qwen3-moe-235b-a22b 64/4), bf16 and float32,
each with its median and digest; a group the checkout's kernel does not
take is reported as such.  Then B3 at qwen3-1.7b's group (16/8) at pages
of 5, 8, 32, 48, 64 and 128 keys, with and without a 100-key window, and
4 rows of 4 096 keys at pages 16 and 128: at pages of 32 keys or fewer
two checkouts' digests must agree (a key-range tile of 32 keys is the
parent's tile of whole pages there); a page the checkout's kernel
refuses is reported as such.  Needs a card.
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


# (Hq, Hkv) of B3's rows: groups 1, 2, 8 and 16.
PAGED_HEADS = ((16, 16), (16, 8), (32, 4), (64, 4))
PAGED_LENS, PAGED_PAGE = [0, 17, 200, 527], 16
# (page, window, kv lens) of B3's page rows, at Hq 16 / Hkv 8.
PAGED_PAGES = tuple((page, window, PAGED_LENS)
                    for page in (5, 8, 32, 48, 64, 128)
                    for window in (None, 100)) + tuple(
    (page, None, [4096] * 4) for page in (16, 128))


def _paged_row(timer, dev, hq, hkv, page, lens, window=None):
    import torch

    from repro_torch.kernels import attention_df

    rows, max_pages = len(lens), -(-max(max(lens), 1024) // page)
    gen = torch.Generator(device=dev).manual_seed(hq + hkv + page)
    n_pages = rows * max_pages + 1
    kp, vp = (torch.randn((hkv, n_pages, page, D), generator=gen,
                          device=dev) for _ in range(2))
    tables = torch.randperm(rows * max_pages, generator=gen,
                            device=dev).reshape(rows, max_pages).to(
                                torch.int32)
    q = torch.randn((rows, hq, 1, D), generator=gen, device=dev)
    kv = torch.tensor(lens, device=dev, dtype=torch.int32)
    row = {"shape": f"paged decode R={rows} kv_lens={lens} page={page} "
                    f"window={window} Hq={hq} Hkv={hkv} D={D}",
           "group": hq // hkv, "page": page, "window": window}
    if hq // hkv > attention_df.MAX_GROUP:
        row["paged"] = f"not taken (MAX_GROUP {attention_df.MAX_GROUP})"
        return row
    for tag, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        args = [t.to(dt) for t in (q, kp, vp)] + [tables, kv]
        paged = lambda: attention_df.paged_flash_attention(*args,
                                                           window=window)
        try:
            got = paged()
        except ValueError as e:      # a page the checkout refuses
            row["paged"] = f"not taken ({e})"
            return row
        row[f"{tag}_paged_sha256"] = _digest(got)
        row[f"{tag}_paged_ms"] = timer.ms(paged)
    return row


def paged_rows(timer, dev: str = "cuda"):
    return ([_paged_row(timer, dev, hq, hkv, PAGED_PAGE, PAGED_LENS)
             for hq, hkv in PAGED_HEADS]
            + [_paged_row(timer, dev, 16, 8, page, lens, window)
               for page, window, lens in PAGED_PAGES])


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
    ap.add_argument("--kernels", choices=("all", "paged"), default="all",
                    help="every row, or B3's alone")
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
    for row in ((rows(timer) if args.kernels == "all" else [])
                + paged_rows(timer)):
        print(json.dumps({"bench": "attention_times", "src": src,
                          "card": card, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
