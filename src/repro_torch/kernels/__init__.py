"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their plain oracles.

fd_gram / fd_project — the two matrix products of the Frequent Directions
shrink; quadform — the batched ``||B x||^2`` serving hot-spot; levscore —
the batched ridge leverage score ``x^T M x`` of leverage tenants;
flash_attention — causal GQA self-attention with an online softmax, the
prefill of the model stack's serving path (bf16 on the tensor cores in
``flash_attention_wgmma.cu``, f32 in ``flash_attention.cu``); mg_scan —
the weighted Misra--Gries scan of heavy-hitter tenants; quant_pack — the
greedy GK compress that ends every quantile merge.  Each kernel
has a source in ``csrc/``, a plain PyTorch version in ``ref.py`` and a
wrapper in ``fd_ops.py`` / ``ops.py`` that launches it on a CUDA tensor and
runs the plain version on a CPU tensor.  ``_build.py`` compiles the sources
with ``nvcc`` at first use.
"""
