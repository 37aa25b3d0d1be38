// The bf16 flash step on the tensor cores, shared by B2 (flash_attention.cu
// `flash_tc_kernel`, output-stationary) and B7 (kv_stationary.cu
// `kv_cluster_kernel`, KV-stationary): one warp folds one 64-key K/V tile
// into the online-softmax state of its 16 query rows. See flash_tc.cuh.
//
// Included inside each kernel's loop, where a warp sees the tile (no
// include guard): the includer holds qf[D / 16][4] (the warp's Q
// fragments), k0 (the tile's first key), t (lane % 4), qpos0 and qpos1 (the
// positions of the warp's rows g and g + 8), kv_valid, skv, causal, window,
// scale, and the state m_run[2], l_run[2], oacc[D / 8][4]; and defines
// FA_LDSM_K(r, row, col) (ldmatrix x4 of the K tile's 16-byte chunk at key
// row, column col) and FA_FRAG_V(b0, b1, k, c) (the B fragments of V's keys
// k.. and columns c.., c + 8..). A function holding the same statements
// cost B2 5% on an H100 (nvcc 12.9; PERF.md, PR 22), so the step is shared
// as text.
//
// Over int8 K/V (codes converted exactly to bf16 in the tiles the macros
// read) the includer also defines FA_KSCALE(j) and FA_VSCALE(j), the K and
// V scales of the tile's key j: the K scale multiplies each score after
// `* scale`, the V scale each probability after it has been summed into l
// and before P is split, the order of ref.attention_ref's folded dequant.
// Without them the step is the bf16 one as it was.
      float s[TKV / 8][4];
#pragma unroll
      for (int i = 0; i < TKV / 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      // S = Q K^T: K's rows are B's columns, so K row-major is B col-major
      // and ldmatrix without .trans gives the fragments.
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
#pragma unroll
        for (int np = 0; np < TKV / 16; ++np) {
          uint32_t r[4];
          const int l = tc::lane();
          FA_LDSM_K(r, np * 16 + (l & 7) + (l >> 4) * 8, c * 16 + ((l >> 3) & 1) * 8);
          const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
          tc::mma_bf16_add(s[2 * np], qf[c], b0);
          tc::mma_bf16_add(s[2 * np + 1], qf[c], b1);
        }
      }
      // Mask, scale and the online softmax on the fragments: this thread
      // holds rows g (j = 0, 1) and g + 8 (j = 2, 3) of the warp's 16, keys
      // 8 i + 2 t + (j & 1).
      float mx[2] = {REPRO_NEG_INF, REPRO_NEG_INF};
#pragma unroll
      for (int i = 0; i < TKV / 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kpos = k0 + i * 8 + 2 * t + (j & 1);
          const int qpos = j < 2 ? qpos0 : qpos1;
          bool valid = kpos < kv_valid && kpos < skv;
          if (causal) valid = valid && kpos <= qpos;
          if (window > 0) valid = valid && kpos > qpos - window;
#ifdef FA_KSCALE
          s[i][j] = valid ? s[i][j] * scale * FA_KSCALE(kpos - k0) : REPRO_NEG_INF;
#else
          s[i][j] = valid ? s[i][j] * scale : REPRO_NEG_INF;
#endif
          mx[j >> 1] = fmaxf(mx[j >> 1], s[i][j]);
        }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m_run[h], mx[h]);
        alpha[h] = expf(m_run[h] - m_new);
        m_run[h] = m_new;
      }
#pragma unroll
      for (int i = 0; i < TKV / 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // A masked key contributes exactly 0, so a fully masked row keeps
          // its state while m is still NEG_INF.
          const float p = s[i][j] > REPRO_NEG_INF ? expf(s[i][j] - m_run[j >> 1]) : 0.f;
          s[i][j] = p;
          sum[j >> 1] += p;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
        l_run[h] = alpha[h] * l_run[h] + sum[h];
      }
#ifdef FA_VSCALE
#pragma unroll
      for (int i = 0; i < TKV / 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] *= FA_VSCALE(i * 8 + 2 * t + (j & 1));
#endif
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) oacc[i][j] *= alpha[j >> 1];
      // O += P V: P's accumulator fragments of keys 16 c.. are the A
      // fragment of chunk c; V row-major (key x d) is B row-major. P is
      // split exactly into three bf16 parts, hi = bf16(p), mid =
      // bf16(p - hi), lo = bf16(p - hi - mid), so it enters the product
      // with ~24 bits, as an f32 P would; each chunk's products (lo, mid,
      // then hi) are summed from zero and added to O with one f32 add.
#pragma unroll
      for (int c = 0; c < TKV / 16; ++c) {
        uint32_t hi[4], mid[4], lo[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float* pr = &s[2 * c + (r >> 1)][(r & 1) * 2];
          hi[r] = tc::pack2_rn(pr[0], pr[1]);
          const float r0 = pr[0] - tc::lo_half(hi[r]), r1 = pr[1] - tc::hi_half(hi[r]);
          mid[r] = tc::pack2_rn(r0, r1);
          lo[r] = tc::pack2_rn(r0 - tc::lo_half(mid[r]), r1 - tc::hi_half(mid[r]));
        }
#pragma unroll
        for (int dn = 0; dn < D / 8; dn += 2) {
          uint32_t b0[2], b1[2];
          FA_FRAG_V(b0, b1, c * 16, dn * 8);
          float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
          tc::mma_bf16(t0, lo, b0);
          tc::mma_bf16(t1, lo, b1);
          tc::mma_bf16(t0, mid, b0);
          tc::mma_bf16(t1, mid, b1);
          tc::mma_bf16(t0, hi, b0);
          tc::mma_bf16(t1, hi, b1);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            oacc[dn][j] = __fadd_rn(oacc[dn][j], t0[j]);
            oacc[dn + 1][j] = __fadd_rn(oacc[dn + 1][j], t1[j]);
          }
        }
      }
