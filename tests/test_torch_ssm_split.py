"""The Mamba2 block, cross attention and the encoder split as a mesh's
``model`` ranks split them, run on one device (``parallel.Splits``), with
no process group.

Each split runs the per-part function a rank's region calls
(``ssm.mamba_part``/``mamba_part_out``, ``lm._enc_attention``,
``lm._cross_prefill``, ``lm._cross_key_range``) on slices of the whole
tensors, the parts summed or merged in rank order.  On the CPU, on seeded
inputs handed to both packages, against the JAX package on one device
(``FWD_TOL``):

  * the mamba2 and hymba smoke decoders with the Mamba2 block over 2 and
    4 ranges of its head dimension (P = 16): the forward, a prefill, then
    decode steps (the last at one index per row), and the state
    assembled from the parts after them equal to the JAX cache's;
  * the whisper smoke encoder-decoder with its encoder's self-attention
    and cross attention to the encoder's output over 2 head ranges, and
    decode's cross attention over 2 and 4 ranges of the 16 encoder
    positions: the forward, prefill and decode logits and the cross
    cache against JAX's;
  * ``layers.bidir_attention``'s row statistics: key ranges merged by
    ``parallel.merge_key_ranges`` against the JAX ``bidir_attention`` over
    all the keys, in both of the reference's dispatches (the plain einsum
    up to 2 048 keys, the chunked online softmax above);
  * counts that do not divide (3 ranges at P = 16; 3 head ranges of 4
    heads, 3 ranges of 16 encoder positions) running the unsplit code,
    bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch import configs
from repro_torch.models import bridge, layers, lm, parallel, ssm

FWD_TOL = dict(atol=1e-4, rtol=1e-4)
BATCH, SEQ, ENC_LEN, MAX_LEN, STEPS = 3, 12, 16, 20, 3


def _case(arch, seed):
    """The port's and the JAX config, the JAX parameters, the port's
    copy of them, and seeded tokens, decode inputs and frames."""
    cfg, jcfg = configs.get_smoke(arch), jconfigs.get_smoke(arch)
    jp = jlm.init_model(jcfg, jax.random.PRNGKey(seed))
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                      device="cpu")
    rng = np.random.default_rng(seed)
    data = {"tokens": rng.integers(0, cfg.vocab_size,
                                   (BATCH, SEQ)).astype(np.int32),
            "decode": rng.integers(0, cfg.vocab_size,
                                   (STEPS, BATCH, 1)).astype(np.int32),
            "ragged": (SEQ + STEPS - 1 - np.arange(BATCH) % 2
                       ).astype(np.int32),
            "frames": (rng.normal(size=(BATCH, ENC_LEN, cfg.d_model))
                       .astype(np.float32) if cfg.is_encoder_decoder
                       else None)}
    return cfg, jcfg, jp, params, data


def _jax_run(jp, jcfg, data):
    """The JAX forward, prefill and decode logits and the last cache."""
    frames = (None if data["frames"] is None
              else jnp.asarray(data["frames"]))
    toks = jnp.asarray(data["tokens"])
    fwd, _ = jlm.forward(jp, toks, jcfg, enc_frames=frames)
    logits, cache = jlm.prefill(jp, toks, jcfg, max_len=MAX_LEN,
                                enc_frames=frames)
    steps = [np.asarray(logits)]
    for j, nxt in enumerate(data["decode"]):
        cache = dict(cache)
        if j == STEPS - 1:
            cache["index"] = jnp.asarray(data["ragged"])
        logits, cache = jlm.decode_step(jp, cache, jnp.asarray(nxt), jcfg)
        steps.append(np.asarray(logits))
    return np.asarray(fwd), np.stack(steps), jax.tree.map(np.asarray, cache)


def _port_run(params, cfg, data, runner):
    """The same through the port, every piece run by ``runner``."""
    frames = (None if data["frames"] is None
              else torch.from_numpy(data["frames"]))
    toks = torch.from_numpy(data["tokens"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(lm, "_runner", lambda dist: runner)
        fwd, _ = lm.forward(params, toks, cfg, enc_frames=frames)
        logits, cache = lm.prefill(params, toks, cfg, max_len=MAX_LEN,
                                   enc_frames=frames)
        steps = [logits]
        for j, nxt in enumerate(data["decode"]):
            if j == STEPS - 1:
                cache["index"] = torch.from_numpy(data["ragged"])
            logits, cache = lm.decode_step(params, cache,
                                           torch.from_numpy(nxt), cfg)
            steps.append(logits)
    return fwd, torch.stack(steps), cache


_JAX = {}


def _reference(arch, seed):
    if arch not in _JAX:
        cfg, jcfg, jp, params, data = _case(arch, seed)
        _JAX[arch] = (cfg, params, data, _jax_run(jp, jcfg, data))
    return _JAX[arch]


def _check(cfg, got, want, names):
    fwd, steps, cache = got
    wfwd, wsteps, wcache = want
    v = cfg.vocab_size
    np.testing.assert_allclose(fwd.numpy()[..., :v], wfwd[..., :v],
                               **FWD_TOL)
    np.testing.assert_allclose(steps.numpy()[..., :v], wsteps[..., :v],
                               **FWD_TOL)
    for name in names:
        assert cache[name].shape == wcache[name].shape, name
        np.testing.assert_allclose(cache[name].numpy(), wcache[name],
                                   **FWD_TOL)


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("arch,seed", [("mamba2-780m", 3),
                                       ("hymba-1.5b", 4)])
def test_p_ranges_match_jax(arch, seed, parts):
    """The Mamba2 block over ``parts`` ranges of P: logits at every step
    and the state assembled from the parts against JAX's."""
    cfg, params, data, want = _reference(arch, seed)
    assert ssm.splits(cfg, parts)
    got = _port_run(params, cfg, data, parallel.Splits(ssm=parts))
    _check(cfg, got, want, lm.SSM_KEYS)


@pytest.mark.parametrize("cross", [2, 4])
def test_whisper_head_and_key_ranges_match_jax(cross):
    """The encoder's attention and cross attention to the encoder's
    output over 2 head ranges, decode's cross attention over ``cross``
    ranges of the encoder positions: logits and the cross cache."""
    cfg, params, data, want = _reference("whisper-tiny", 5)
    assert parallel._heads_split(cfg, 2) == "heads"
    got = _port_run(params, cfg, data,
                    parallel.Splits(heads=2, cross=cross))
    _check(cfg, got, want, lm.CROSS_KEYS)


@pytest.mark.parametrize("arch,runner", [
    ("mamba2-780m", dict(ssm=3)), ("hymba-1.5b", dict(ssm=3)),
    ("whisper-tiny", dict(heads=3, cross=3))])
def test_counts_that_do_not_divide_run_unsplit_bits(arch, runner):
    """3 ranges of P = 16, of 4 heads, of 16 encoder positions: no split,
    the one-device code's bits."""
    cfg, params, data, _ = _reference(arch, {"mamba2-780m": 3,
                                             "hymba-1.5b": 4,
                                             "whisper-tiny": 5}[arch])
    want = _port_run(params, cfg, data, lm.ONE_DEVICE)
    got = _port_run(params, cfg, data, parallel.Splits(**runner))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for name in ("ssm", "conv", "cross_k", "cross_v"):
        if name in want[2]:
            assert torch.equal(got[2][name], want[2][name]), name


@pytest.mark.parametrize("parts", [1, 2, 4])
def test_mamba_parts_sum_to_the_block(parts):
    """``mamba_part`` and ``mamba_part_out`` over every part, their sums
    of squares and outputs summed, against ``mamba_apply`` (L > 1: the
    chunked SSD, L = 1: the recurrence), and the parts' states
    assembled against the whole block's; one part is the block's own
    arithmetic but for the norm's sum over the squares, so it agrees to
    float rounding."""
    cfg = configs.get_smoke("mamba2-780m")
    p = {k: v[0] for k, v in
         lm.init_model(cfg, seed=1, device="cpu")["layers"]["mamba"].items()}
    gen = torch.Generator().manual_seed(parts)
    h, n, pd = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim
    for length in (1, 10):
        x = torch.randn(2, length, cfg.d_model, generator=gen)
        state = (torch.randn(2, h, n, pd, generator=gen),
                 torch.randn(2, cfg.ssm_conv - 1, cfg.d_inner + 2 * n,
                             generator=gen))
        want, wstate = ssm.mamba_apply(p, x, cfg, state)
        ws = [ssm.param_part(p, cfg, r, parts) for r in range(parts)]
        got = [ssm.mamba_part(w, x, cfg, ssm.state_part(state, cfg, r,
                                                        parts))
               for r, w in enumerate(ws)]
        total = sum(sq for _, sq, _ in got)
        out = sum(ssm.mamba_part_out(w, g, total, cfg)
                  for w, (g, _, _) in zip(ws, got))
        np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-5,
                                   rtol=1e-5)
        for a, b in zip(ssm.assemble_state([st for _, _, st in got], cfg),
                        wstate):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                       rtol=1e-5)


@pytest.mark.parametrize("skv,ranges", [(48, 3), (4200, 2)],
                         ids=["plain", "chunked"])
def test_bidir_key_ranges_merge_to_jax(skv, ranges):
    """``bidir_attention(return_lse=True)`` over ranges of the keys,
    merged, against the JAX ``bidir_attention`` over all of them (GQA
    group 2); each range's statistic against a ``logsumexp`` of its
    logits.  4 200 keys put both the whole and each range of 2 100 on
    the chunked path."""
    rng = np.random.default_rng(skv)
    b, hq, hkv, sq, d = 2, 4, 2, 3, 16
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in
               ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))
    scale = d ** -0.5
    want = np.asarray(jlayers.bidir_attention(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v), scale))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    w = skv // ranges
    outs, lses = [], []
    for r in range(ranges):
        kr, vr = tk[:, :, r * w:(r + 1) * w], tv[:, :, r * w:(r + 1) * w]
        out, lse = layers.bidir_attention(tq, kr, vr, scale,
                                          return_lse=True)
        logits = torch.einsum("bhgqd,bhkd->bhgqk",
                              tq.reshape(b, hkv, hq // hkv, sq, d),
                              kr) * scale
        np.testing.assert_allclose(
            lse.numpy(), torch.logsumexp(logits, -1).reshape(
                b, hq, sq).numpy(), atol=1e-5, rtol=1e-5)
        assert torch.equal(out, layers.bidir_attention(tq, kr, vr, scale))
        outs.append(out)
        lses.append(lse)
    got = parallel.merge_key_ranges(outs, lses)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_split_shapes_of_the_configs():
    """Which configs' blocks split over which ``model`` sizes: the head
    dimension (P 64 at full width, 16 in the smoke configs) for the
    Mamba2 block, the heads for the encoder and cross attention
    (whisper-tiny's 6)."""
    for arch in ("mamba2-780m", "hymba-1.5b"):
        full = configs.get(arch)
        assert [ssm.splits(full, n) for n in (1, 2, 3, 4, 16)] == [
            False, True, False, True, True], arch
        smoke = configs.get_smoke(arch)
        assert [ssm.splits(smoke, n) for n in (2, 3, 4, 32)] == [
            True, False, True, False], arch
    tiny = configs.get("whisper-tiny")
    assert [parallel._heads_split(tiny, n) for n in (2, 3, 4, 6, 16)] == [
        "heads", "heads", None, "heads", None]
