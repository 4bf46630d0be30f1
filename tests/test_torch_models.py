"""The port's serving path of the model stack against the reference.

Weights come from the reference's ``LM.init`` through
``params_from_reference``; prompts and attention inputs from a numpy seed.
Everything runs in f32 on the CPU, where ``kernels.ops.flash_attention``
runs its plain version (the CUDA kernel is held to it on the card, in
``test_torch_cuda.py`` and ``chip_smoke.py``).

Tolerances:
  * attention against the reference's plain version: 1e-5 of the largest
    output (f32, the same arithmetic in another summation order); against
    the reference's Pallas kernel (interpreted): its own 3e-4
    (``tests/test_kernels.py``);
  * logits of the whole model: 1e-4 of the largest logit (two layers of f32
    projections, norms and softmax summed in another order by two libraries);
  * decode against the full forward: the reference's own 2e-3
    (``tests/test_serve.py``);
  * greedy tokens: equal.

The reference's ``attn_impl="pallas"`` model path hands its kernel keys and
values transposed twice (``attn_apply`` passes them as (B, KVH, T, Dh) and
``_self_attention_pallas`` transposes them again), so it fails whenever T
differs from the number of KV heads (ROADMAP §3).  The ``reference_pallas``
fixture undoes that second transpose for the duration of a test, without
touching ``src/repro``, so the port's kernel path is held to the reference's
interpreted Pallas kernel inside the model.
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCH_NAMES as J_ARCH_NAMES
from repro.configs.registry import get_config as j_get_config
from repro.configs.registry import reduced_config as j_reduced_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattention
from repro.models.config import ModelConfig as JModelConfig
from repro.models.transformer import LM as JLM
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs.registry import ARCH_NAMES, get_config, reduced_config
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as launch_serve
from repro_torch.models import LM, ModelConfig, params_from_reference
from repro_torch.serve import ServeConfig, ServeEngine

ATTN_RTOL = 1e-5
PALLAS_TOL = 3e-4
LOGIT_RTOL = 1e-4
DECODE_ATOL = 2e-3

# tests/test_serve.py's two configs: GQA, and windowed (a ring cache of 8).
GQA = JModelConfig(name="t", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                   d_ff=128, vocab_size=128, dtype="float32", remat="none")
SWA = JModelConfig(name="t", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                   d_ff=128, vocab_size=64, window=8, layer_pattern=("local",),
                   dtype="float32", remat="none")
QWEN = j_reduced_config(j_get_config("qwen3-0.6b"))


def _close(got, want, rtol, atol=None):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    if atol is None:
        atol = rtol * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.fixture
def reference_pallas(monkeypatch):
    """The reference's Pallas attention path, with keys and values in the layout
    its ``_self_attention_pallas`` expects, (B, T, KVH, Dh)."""
    pallas = jattention._self_attention_pallas

    def fixed(cfg, q, kt, vt, window):
        return pallas(cfg, q, kt.transpose(0, 2, 1, 3), vt.transpose(0, 2, 1, 3), window)

    monkeypatch.setattr(jattention, "_self_attention_pallas", fixed)


@functools.lru_cache(maxsize=None)
def _reference_params(jcfg, seed):
    return jax.jit(JLM(jcfg).init)(jax.random.key(seed))


def _pair(jcfg, seed=0):
    """The reference's LM with its weights, and the port's LM on the same weights."""
    jlm = JLM(jcfg)
    # attn_impl and attn_block_q do not touch the weights.
    params = _reference_params(dataclasses.replace(jcfg, attn_impl="xla", attn_block_q=512), seed)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(params_from_reference(cfg, jax.tree.map(np.asarray, params)))
    return jlm, params, lm


def _tokens(cfg, b, t, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(b, t)).astype(np.int32)


@pytest.mark.parametrize("b,hq,hkv,s,dh,window,softcap", [
    (1, 4, 2, 256, 64, 0, 0.0),  # GQA
    (1, 2, 2, 256, 64, 96, 0.0),  # sliding window
    (1, 4, 4, 200, 64, 0, 30.0),  # ragged s with a soft-cap
])
def test_attention_matches_reference(b, hq, hkv, s, dh, window, softcap):
    rng = np.random.default_rng(s + window)
    q = rng.normal(size=(b, hq, s, dh)).astype(np.float32)
    k = rng.normal(size=(b, hkv, s, dh)).astype(np.float32)
    v = rng.normal(size=(b, hkv, s, dh)).astype(np.float32)
    kw = dict(window=window, logit_softcap=softcap)
    tq, tk, tv = torch.tensor(q), torch.tensor(k), torch.tensor(v)
    plain = ref.ref_attention(tq, tk, tv, **kw)
    _close(plain, jref.ref_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw),
           ATTN_RTOL)
    pallas = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    _close(ops.flash_attention(tq, tk, tv, **kw), pallas, PALLAS_TOL, PALLAS_TOL)
    # Views in the model's (B, T, H, Dh) layout are taken as they come.
    got = ops.flash_attention(tq.transpose(1, 2).contiguous().transpose(1, 2), tk, tv, **kw)
    assert torch.equal(got, plain)


def test_flash_attention_wrapper_checks_operands():
    q, k = torch.zeros(1, 4, 8, 32), torch.zeros(1, 2, 8, 32)
    with pytest.raises(ValueError, match="self-attention"):
        ops.flash_attention(q, k[:, :, :4], k[:, :, :4])
    with pytest.raises(ValueError, match="GQA"):
        ops.flash_attention(q, torch.zeros(1, 3, 8, 32), torch.zeros(1, 3, 8, 32))
    with pytest.raises(TypeError, match="bfloat16"):
        ops.flash_attention(q.double(), k.double(), k.double())
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.flash_attention(q.to("meta"), k.to("meta"), k.to("meta"))
    ops.reset_launch_counts()
    out = ops.flash_attention(q.bfloat16(), k.bfloat16(), k.bfloat16())
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert ops.launch_counts()["flash_attention"] == 0  # the plain version is no launch


@pytest.mark.parametrize("jcfg,impl", [
    pytest.param(QWEN, "xla", id="qwen3-reduced-xla"),
    pytest.param(QWEN, "xla_chunked", id="qwen3-reduced-xla_chunked"),
    pytest.param(QWEN, "pallas", id="qwen3-reduced-pallas"),
    pytest.param(GQA, "pallas", id="gqa-pallas"),
    pytest.param(SWA, "pallas", id="window-pallas"),
])
def test_forward_logits_match_reference(jcfg, impl, reference_pallas):
    """Every implementation on the reduced Qwen3; the kernel's path also on
    GQA and windowed configs (the windowed ``xla_chunked`` prefill is held to
    the reference in the ring-cache test)."""
    # 8-row query blocks: the chunked path loops, and slices keys for the window.
    jcfg = dataclasses.replace(jcfg, attn_impl=impl, attn_block_q=8)
    jlm, params, lm = _pair(jcfg)
    toks = _tokens(jcfg, 2, 32, seed=3)
    want, _ = jax.jit(jlm.forward)(params, jnp.asarray(toks))
    with torch.no_grad():
        got, _ = lm(torch.tensor(toks))
    _close(got, want, LOGIT_RTOL)


def test_prefill_decode_and_greedy_generate_match_reference(reference_pallas):
    jcfg = dataclasses.replace(GQA, attn_impl="pallas")
    jlm, params, lm = _pair(jcfg)
    toks = _tokens(jcfg, 2, 24, seed=0)
    jprefill, jdecode = jax.jit(jlm.prefill, static_argnums=2), jax.jit(jlm.decode_step)
    jlogits, jcache = jprefill(params, jnp.asarray(toks[:, :16]), 64)
    with torch.no_grad():
        logits, cache = lm.prefill(torch.tensor(toks[:, :16]), 64)
        _close(logits, jlogits, LOGIT_RTOL)
        for i in range(16, 24):
            jlogits, jcache = jdecode(params, jcache, jnp.asarray(toks[:, i:i + 1]),
                                      jnp.asarray(i, jnp.int32))
            logits, cache = lm.decode_step(cache, torch.tensor(toks[:, i:i + 1]), i)
            _close(logits, jlogits, LOGIT_RTOL)
    prompts = toks[:, :16]
    # The reference's engine calls its model's prefill eagerly: hand it the
    # jitted one compiled above (the same function on the same shapes).
    jserve_lm = types.SimpleNamespace(prefill=jprefill, decode_step=jlm.decode_step)
    want = JServeEngine(jserve_lm, params, JServeConfig(max_len=64)).generate(
        jnp.asarray(prompts), 8)
    got = ServeEngine(lm, ServeConfig(max_len=64)).generate(torch.tensor(prompts), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_swa_ring_cache_matches_reference_across_the_wrap():
    """Decode with the window-sized ring cache, wrapping several times, against
    the reference's decode and the port's own full forward."""
    jlm, params, lm = _pair(SWA)
    toks = _tokens(SWA, 1, 30, seed=1)
    assert lm.init_cache(1, 64)[0]["k"].shape[-2] == 8, "ring cache must be window-sized"
    jdecode = jax.jit(jlm.decode_step)
    _, jcache = jax.jit(jlm.prefill, static_argnums=2)(params, jnp.asarray(toks[:, :12]), 64)
    with torch.no_grad():
        _, cache = lm.prefill(torch.tensor(toks[:, :12]), 64)
        for i in range(12, 30):
            jdec, jcache = jdecode(params, jcache, jnp.asarray(toks[:, i:i + 1]),
                                   jnp.asarray(i, jnp.int32))
            dec, cache = lm.decode_step(cache, torch.tensor(toks[:, i:i + 1]), i)
            _close(dec, jdec, LOGIT_RTOL)
            full, _ = lm(torch.tensor(toks[:, :i + 1]))
            err = float((dec[:, 0] - full[:, -1]).abs().max())
            assert err < DECODE_ATOL, (i, err)


def test_bf16_reference_weights_carry_over_bit_for_bit():
    """bf16 leaves of the reference's tree (numpy's ml_dtypes bfloat16),
    unstacked from their scan group, load bit for bit."""
    params = _reference_params(dataclasses.replace(GQA, attn_impl="xla"), 0)
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)), params)
    cfg = ModelConfig(**dataclasses.asdict(dataclasses.replace(GQA, dtype="bfloat16")))
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(params_from_reference(cfg, tree))
    got = lm.blocks[1].attn["wq"]
    assert got.dtype == torch.bfloat16
    want = tree["groups"][0]["pos0"]["attn"]["wq"][1]  # layer 1: repeat 1 of the scan group
    np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))


def test_configs_match_reference_and_unported_kinds_raise(monkeypatch):
    assert ARCH_NAMES == J_ARCH_NAMES
    for name in ARCH_NAMES:
        assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(j_get_config(name))
        assert dataclasses.asdict(reduced_config(get_config(name))) == dataclasses.asdict(
            j_reduced_config(j_get_config(name)))
    for name, what in (("mixtral-8x7b", "MoE"), ("recurrentgemma-2b", "rglru"),
                       ("mamba2-370m", "ssd")):
        with pytest.raises(NotImplementedError, match=f"{what}.*ROADMAP item 12b"):
            LM(reduced_config(get_config(name)), device="cpu")
    lm = LM(reduced_config(get_config("qwen3-0.6b")), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP item 12b"):
        lm(torch.zeros(1, 4, dtype=torch.long), vision_embeds=torch.zeros(1, 2, 128))
    with pytest.raises(NotImplementedError, match="training run.*ROADMAP item 12c"):
        launch_serve.main(["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu",
                           "--ckpt-dir", "ckpt"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LM(reduced_config(get_config("qwen3-0.6b")))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_serve.main(["--arch", "qwen3-0.6b", "--reduced"])


def test_serve_launcher_runs_on_the_cpu(capsys):
    launch_serve.main(["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu", "--batch", "2",
                       "--gen", "4"])
    out = capsys.readouterr().out
    assert "[serve] qwen3-0.6b: 2x4 tokens" in out
    assert "greedy consistency vs teacher-forced forward: 100.0%" in out
