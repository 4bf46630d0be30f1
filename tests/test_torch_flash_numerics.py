"""Why the bf16 flash kernel splits its softmax weights in two (CPU only).

``csrc/flash_attention_wgmma.cu`` runs ``O += P V`` on the tensor cores,
which take P in bf16.  This test emulates that product in plain PyTorch, in
f64 except where the kernel rounds, on bf16 inputs made from a seed, and
holds the bf16 output to ``ref.ref_attention`` on the same inputs in f32
with the per-element check of the card tests and ``chip_smoke.py``:
``|k - p| <= 2^-8 |p| + 1e-5 max |p|``.  P split as ``P_hi = bf16(P)``,
``P_lo = bf16(P - P_hi)`` meets it; P rounded once to bf16 misses it by more
than ten times.
"""
import numpy as np
import torch

from repro_torch.kernels import ref

B, HQ, HKV, S, DH = 1, 4, 2, 700, 128
BF16_ROUNDING, ATOL_SHARE = 2.0**-8, 1e-5


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).double()


def _emulated(q, k, v, split: bool) -> torch.Tensor:
    """Causal GQA attention with P rounded to bf16 once, or split in two bf16 terms."""
    group = HQ // HKV
    qd = q.double()
    kd, vd = (t.double().repeat_interleave(group, 1) for t in (k, v))
    logits = torch.einsum("bhqd,bhkd->bhqk", qd, kd) * DH**-0.5
    causal = torch.ones(S, S, dtype=torch.bool).tril()
    logits = logits.masked_fill(~causal, float("-inf"))
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    denom = p.sum(-1, keepdim=True)
    p_hi = _bf16(p)
    p_mma = p_hi + _bf16(p - p_hi) if split else p_hi
    return (torch.einsum("bhqk,bhkd->bhqd", p_mma, vd) / denom).to(torch.bfloat16)


def _worst_err_over_tol(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    tol = BF16_ROUNDING * want.abs() + ATOL_SHARE * want.abs().max()
    return float(((got - want).abs() / tol).max())


def test_split_softmax_weights_meet_the_bf16_check_and_one_rounding_does_not():
    rng = np.random.default_rng(700)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, h, S, DH)).astype(np.float32))
               .to(torch.bfloat16) for h in (HQ, HKV, HKV))
    want = ref.ref_attention(q.float(), k.float(), v.float())
    split = _worst_err_over_tol(_emulated(q, k, v, split=True), want)
    single = _worst_err_over_tol(_emulated(q, k, v, split=False), want)
    assert split <= 1.0, split
    assert single > 10.0, single
